"""An installed port can build and launch its kernels.

The wheel is built offline from a copy of the tree (`pip wheel --no-deps
--no-build-isolation --no-index`), as a user without network builds it:

  * it ships the port's CUDA sources and the data files the port reads
    beside its modules, names the `kiss_icp_tpu_torch_capacity_plan` script,
    and offers torch as the extra `torch`, not as a base dependency (the JAX
    package's users install the same wheel);
  * installed with `--target` into a directory marked read-only and imported
    from there alone, the port finds both sources and builds into the user
    cache (`$XDG_CACHE_HOME/kiss_icp_tpu_torch/build`), writing nothing into
    the install; a missing source or a build that cannot run (no nvcc)
    raises and names both build directories;
  * its console script runs a drive on the CPU with the poses of the
    checkout's own CLI;
  * in the checkout, the kernels still build into `kiss_icp_tpu_torch/_build/`.

The build itself (nvcc) and the launches from an installed copy are
chip_smoke.py's phase "install", on the card.
"""

import json
import os
import shutil
import stat
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest

from kiss_icp_tpu_torch.kernels import _build

REPO = Path(__file__).resolve().parent.parent
SOURCES = ("pyproject.toml", "README.md", "kiss_icp_tpu", "kiss_icp_tpu_torch")
SHIPPED = ("kiss_icp_tpu_torch/csrc/linsys.cu", "kiss_icp_tpu_torch/csrc/nn27.cu",
           "kiss_icp_tpu_torch/tools/golden_cli_drive.json",
           "kiss_icp_tpu_torch/ros/params.example.yaml")
PIP = (sys.executable, "-m", "pip", "--disable-pip-version-check", "--no-input")


def _pip(*args, timeout=300):
    out = subprocess.run([*PIP, *args], capture_output=True, text=True, timeout=timeout,
                         env=dict(os.environ, PIP_NO_INDEX="1"))
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]


def _tree(root: Path):
    """{relative path: (size, mtime_ns)} of every entry under `root`."""
    return {p.relative_to(root).as_posix(): (p.lstat().st_size, p.lstat().st_mtime_ns)
            for p in root.rglob("*")}


def _set_writable(root: Path, writable: bool):
    bits = stat.S_IWUSR | stat.S_IWGRP | stat.S_IWOTH
    for p in [root, *root.rglob("*")]:
        if p.is_symlink():
            continue
        mode = p.stat().st_mode
        p.chmod((mode | stat.S_IWUSR) if writable else (mode & ~bits))


@pytest.fixture(scope="module")
def wheel(tmp_path_factory):
    """The wheel built offline from a copy of the tree's packaging files
    and packages (no build products, no caches)."""
    work = tmp_path_factory.mktemp("wheel")
    src = work / "src"
    src.mkdir()
    ignore = shutil.ignore_patterns("_build", "__pycache__", "*.so", "*.egg-info")
    for name in SOURCES:
        path = REPO / name
        if path.is_dir():
            shutil.copytree(path, src / name, ignore=ignore)
        else:
            shutil.copy2(path, src / name)
    _pip("wheel", "--no-deps", "--no-build-isolation", "--no-index", "-q",
         "-w", str(work / "dist"), str(src))
    wheels = sorted((work / "dist").glob("*.whl"))
    assert len(wheels) == 1, wheels
    return wheels[0]


@pytest.fixture(scope="module")
def installed(wheel, tmp_path_factory):
    """The wheel installed with --target, then every entry marked read-only."""
    target = tmp_path_factory.mktemp("site") / "target"
    _pip("install", "--no-deps", "--no-index", "-q", "--target", str(target), str(wheel))
    _set_writable(target, False)
    yield target
    _set_writable(target, True)


def test_wheel_ships_the_cuda_sources_and_data_files(wheel):
    with zipfile.ZipFile(wheel) as z:
        names = set(z.namelist())
    missing = [f for f in SHIPPED if f not in names]
    assert not missing, f"{wheel.name} lacks {missing}"
    assert not [n for n in names if "/_build/" in n or n.endswith(".so")]


def test_wheel_names_the_capacity_plan_script_and_the_torch_extra(wheel):
    with zipfile.ZipFile(wheel) as z:
        info = next(n for n in z.namelist() if n.endswith(".dist-info/entry_points.txt"))
        scripts = z.read(info).decode()
        meta = z.read(info.replace("entry_points.txt", "METADATA")).decode()
    assert ("kiss_icp_tpu_torch_capacity_plan = kiss_icp_tpu_torch.tools.capacity_plan:main"
            in scripts)
    assert "kiss_icp_tpu_torch_pipeline = kiss_icp_tpu_torch.tools.cmd:main" in scripts
    requires = [ln for ln in meta.splitlines() if ln.startswith("Requires-Dist:")]
    assert "Provides-Extra: torch" in meta.splitlines()
    torch_reqs = [r for r in requires if r.split()[1].split(";")[0] == "torch"]
    assert torch_reqs and all('extra == "torch"' in r for r in torch_reqs), torch_reqs


def _installed_env(target: Path, cache: Path) -> dict:
    """The install alone on the import path, and a user cache of its own."""
    return dict(os.environ, PYTHONPATH=str(target), XDG_CACHE_HOME=str(cache))


def test_installed_copy_builds_into_the_user_cache(installed, tmp_path):
    code = (
        "import json, sys\n"
        "import kiss_icp_tpu_torch\n"
        "from kiss_icp_tpu_torch.kernels import _build\n"
        "try:\n"
        "    _build.library('missing')\n"
        "except KeyError as e:\n"
        "    missing = str(e)\n"
        "print(json.dumps({'package': kiss_icp_tpu_torch.__file__,\n"
        "                  'sources': sorted(_build.sources()),\n"
        "                  'build_dir': str(_build.build_dir()), 'missing': missing,\n"
        "                  'jax': [m for m in sys.modules if m.split('.')[0] in\n"
        "                          ('jax', 'kiss_icp_tpu')]}))\n"
    )
    cache = tmp_path / "cache"
    before = _tree(installed)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env=_installed_env(installed, cache))
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert Path(got["package"]).parent == installed / "kiss_icp_tpu_torch"
    assert got["sources"] == ["linsys", "nn27"]
    build_dir = Path(got["build_dir"])
    assert build_dir.parent == cache / "kiss_icp_tpu_torch" / "build"
    # Both build directories named where a source is missing.
    assert str(installed / "kiss_icp_tpu_torch" / "_build") in got["missing"]
    assert str(cache / "kiss_icp_tpu_torch" / "build") in got["missing"]
    assert got["jax"] == []
    assert _tree(installed) == before, "the installed run wrote into the install"


def test_installed_cli_drives_on_the_cpu_as_the_checkout(installed, tmp_path):
    """The installed `kiss_icp_tpu_torch_pipeline` over three scans with
    --device cpu: the poses of the checkout's own CLI, bit for bit."""
    from kiss_icp_tpu_torch.tools import cmd

    data = tmp_path / "scans"
    data.mkdir()
    rng = np.random.default_rng(3)
    base = rng.uniform(-20, 20, (3000, 3)).astype(np.float32)
    for i in range(3):
        scan = np.zeros((len(base), 4), np.float32)
        scan[:, :3] = base - np.float32(0.2 * i) * np.array([1, 0.1, 0], np.float32)
        scan.tofile(data / f"{i:06d}.bin")
    config = {"data": {"max_range": 50.0, "min_range": 1.0, "deskew": False},
              "mapping": {"voxel_size": 1.0},
              "engine": {"max_points_per_frame": 4096, "frame_capacity": 4096,
                         "source_capacity": 1024, "map_capacity_log2": 12}}
    poses = {}
    for label in ("installed", "checkout"):
        cfg = dict(config, out_dir=str(tmp_path / label))
        cfg_file = tmp_path / f"{label}.yml"
        cfg_file.write_text(json.dumps(cfg))
        argv = [str(data), "--dataloader", "generic", "--config", str(cfg_file),
                "--device", "cpu"]
        if label == "installed":
            script = installed / "bin" / "kiss_icp_tpu_torch_pipeline"
            out = subprocess.run([sys.executable, str(script), *argv], cwd=tmp_path,
                                 capture_output=True, text=True, timeout=300,
                                 env=_installed_env(installed, tmp_path / "cache"))
            assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
        else:
            assert cmd.main(argv) == 0
        poses[label] = np.load(tmp_path / label / "latest" / "scans_poses.npy")
    assert poses["installed"].shape == (3, 4, 4)
    np.testing.assert_array_equal(poses["installed"], poses["checkout"])


def test_checkout_builds_into_the_package_dir():
    assert _build.build_root() == REPO / "kiss_icp_tpu_torch" / "_build"
    assert _build.build_dir().parent == REPO / "kiss_icp_tpu_torch" / "_build"


def test_missing_nvcc_names_both_build_directories(monkeypatch, tmp_path):
    """A build that cannot run raises, naming the package's build directory
    and the user cache; nothing falls back."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    monkeypatch.setattr(_build, "build_root", lambda: tmp_path / "root")
    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc not found") as err:
        _build.build_all.__wrapped__()
    assert str(REPO / "kiss_icp_tpu_torch" / "_build") in str(err.value)
    assert str(tmp_path / "cache" / "kiss_icp_tpu_torch" / "build") in str(err.value)
