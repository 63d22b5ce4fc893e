"""Build the CUDA sources under `csrc/` with nvcc at first use, load with ctypes.

Each `csrc/<name>.cu` becomes `_build/<hash>/<name>.so`, a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds). The
directory is keyed by a hash of every source and of the flags, so an edited
source never loads a stale library. All sources compile in parallel, one
nvcc process each. A failed build raises; nothing falls back.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine without nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, into build.log
)


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC_DIR.glob("*.cu"))}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, "
                           "/usr/local/cuda and $PATH); the CUDA kernels cannot "
                           "be built")
    return found


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name, path in sources().items():
        h.update(name.encode())
        h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def build_all() -> Path:
    """Compile every csrc/*.cu that is not built yet; return the directory.
    The ptxas report of each build is appended to `<dir>/build.log`."""
    out = build_dir()
    todo = {n: p for n, p in sources().items() if not (out / f"{n}.so").is_file()}
    if not todo:
        return out
    out.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name, src in todo.items():
        tmp = out / f"{name}.so.{os.getpid()}.tmp"
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failures = []
    with open(out / "build.log", "a") as log:
        for name, (tmp, proc) in procs.items():
            text, _ = proc.communicate()
            log.write(f"== {name}.cu (rc={proc.returncode})\n{text}\n")
            if proc.returncode != 0:
                failures.append(f"{name}.cu:\n{text}")
            else:
                os.replace(tmp, out / f"{name}.so")
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return out


def build_log() -> str:
    path = build_all() / "build.log"
    return path.read_text() if path.is_file() else ""


def _kernel_name(mangled: str) -> str:
    """`linsys_kernel` or `nn27_kernel<1>` from an Itanium-mangled name: the
    identifier `<len><name>_kernel` whose length prefix matches, then a
    bool template argument if there is one."""
    for m in re.finditer(r"(?=(\d+)([a-z][a-z0-9_]*?_kernel)(ILb([01])E)?)", mangled):
        if int(m.group(1)) == len(m.group(2)):
            return m.group(2) + (f"<{m.group(4)}>" if m.group(4) else "")
    return mangled


def ptxas_report() -> List[str]:
    """One line per compiled kernel from the build log: its name (template
    flag as <0>/<1>), registers, stack, spills and shared memory."""
    lines, name = [], None
    for ln in build_log().splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", ln)
        if entry:
            name, spill = _kernel_name(entry.group(1)), ""
        elif name and "spill" in ln:
            spill = ln.strip()
        elif name and "Used" in ln and "registers" in ln:
            lines.append(f"{name}: {ln.split(':', 1)[1].strip()}; {spill}")
            name = None
    return lines


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded shared library built from csrc/<name>.cu."""
    if name not in sources():
        raise KeyError(f"no CUDA source csrc/{name}.cu")
    return ctypes.CDLL(str(build_all() / f"{name}.so"))


def check_tensor(t, name: str, dtype, shape, device) -> int:
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on the CUDA
    `device`, aligned to its element size: a kernel reads it through a raw
    pointer. Returns that pointer."""
    ptr = t.data_ptr()
    if t.dtype != dtype or t.shape != shape or t.device != device \
            or not t.is_contiguous() or ptr % t.element_size():
        raise ValueError(f"{name}: expected a contiguous, aligned CUDA {dtype} tensor "
                         f"of shape {shape} on {device}, got {t.device} {t.dtype} "
                         f"{tuple(t.shape)} contiguous={t.is_contiguous()} "
                         f"address={ptr:#x}")
    return ptr


def stream_getter():
    """f(device index) -> the raw cudaStream_t of that device's current
    stream, as an int: PyTorch's own accessor, which builds no Stream object
    per call (the wrappers run about 20 times a frame)."""
    import torch

    return torch._C._cuda_getCurrentRawStream


def check_error(code: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
