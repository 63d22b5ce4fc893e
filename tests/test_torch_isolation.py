"""The port stands alone: no module of kiss_icp_tpu_torch, no file of its
ament package ros_torch/, not chip_smoke.py nor the test helpers it
imports (the property runners tests/torch_properties.py, the loop count
tests/torch_gn_count.py), and no code cell of the port's eval
notebooks (eval_torch/) imports JAX, the JAX package or the root bench.py
(the port's bench is tools/bench.py); the notebooks are valid nbformat-4
documents stored without outputs, the twins of eval/'s; importing every
port module builds nothing and needs no card; chip_smoke.py refuses to run
without one.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "kiss_icp_tpu_torch"
NOTEBOOKS = REPO / "eval_torch"
FORBIDDEN = ("jax", "jaxlib", "kiss_icp_tpu", "bench")  # bench: the root bench.py


def _port_files():
    return (sorted(PORT.rglob("*.py")) + sorted((REPO / "ros_torch").rglob("*.py"))
            + [REPO / "chip_smoke.py", REPO / "tests" / "torch_properties.py",
               REPO / "tests" / "torch_gn_count.py"])


def _code_cells(path):
    with open(path) as f:
        nb = json.load(f)
    return nb, ["".join(c["source"]) for c in nb["cells"] if c["cell_type"] == "code"]


def _modules():
    return sorted(".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
                  for p in PORT.rglob("*.py"))


def _imported_roots(path, source=None):
    tree = ast.parse(path.read_text() if source is None else source, filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_neither_jax_nor_the_jax_package(path):
    bad = [m for m in _imported_roots(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted(NOTEBOOKS.glob("*.ipynb")), ids=lambda p: p.name)
def test_notebook_cells_import_only_the_port(path):
    _, cells = _code_cells(path)
    roots = [m for src in cells for m in _imported_roots(path, src)]
    bad = [m for m in roots if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"
    assert any(m.split(".")[0] == "kiss_icp_tpu_torch" for m in roots), path.name


def test_eval_notebooks_valid_and_syntactic():
    """The port's notebooks are eval/'s six, each a valid nbformat-4
    document whose code cells compile, stored without outputs, with a
    DEVICE cell (tests/test_eval_harness.py checks eval/ the same way)."""
    names = sorted(p.name for p in NOTEBOOKS.glob("*.ipynb"))
    assert names == sorted(p.name for p in (REPO / "eval").glob("*.ipynb"))
    for name in names:
        nb, cells = _code_cells(NOTEBOOKS / name)
        assert nb["nbformat"] == 4
        assert cells, name
        for i, src in enumerate(cells):
            compile(src, f"{name} cell {i}", "exec")
        for cell in nb["cells"]:
            assert not cell.get("outputs"), f"{name}: notebooks are stored without outputs"
        assert any(src.startswith('DEVICE = "cuda"') for src in cells), name


def test_importing_every_module_leaves_jax_out():
    code = (
        "import importlib, sys\n"
        f"for name in {_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "import torch\n"
        "assert torch.backends.cuda.matmul.allow_tf32 is False\n"
        "assert torch.backends.cudnn.allow_tf32 is False\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "from kiss_icp_tpu_torch.kernels import _build\n"
        "assert _build.build_all.cache_info().currsize == 0  # nothing built\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """No CUDA device here: the script exits non-zero and prints no result
    line, both in the checkout and alone in an empty directory."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    for script in (REPO / "chip_smoke.py", alone):
        out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
