"""Build the CUDA sources under `csrc/` with nvcc at first use, load with ctypes.

Each `csrc/<name>.cu` becomes `<root>/<hash>/<name>.so`, a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds). The
directory is keyed by a hash of every source and of the flags, so an edited
source never loads a stale library. All sources compile in parallel, one
nvcc process each. A failed build raises; nothing falls back.

`<root>` is the package's own `_build/` when that directory can be created
and written (a checkout), else the user's cache,
`$XDG_CACHE_HOME/kiss_icp_tpu_torch/build` (default `~/.cache/...`): an
installed package may sit in a read-only site-packages. Either way nvcc
builds the same sources. Processes that build at once each write their own
temporary file and rename it into place, so none loads a half-written
library.

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
import stat
import subprocess
from pathlib import Path
from typing import Dict, List

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
PACKAGE_BUILD_ROOT = PACKAGE_DIR / "_build"

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


def cache_build_root() -> Path:
    """The user-cache build root: $XDG_CACHE_HOME, else ~/.cache."""
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return Path(cache) / "kiss_icp_tpu_torch" / "build"


def _writable(path: Path) -> bool:
    """Whether `path` is a directory this process may write in, by its own
    permission bits as well as by the file system: a directory marked
    read-only counts as read-only even for root, who could write it anyway."""
    try:
        st = path.stat()
    except OSError:
        return False
    if st.st_uid == os.geteuid():
        bit = stat.S_IWUSR
    elif st.st_gid == os.getegid() or st.st_gid in os.getgroups():
        bit = stat.S_IWGRP
    else:
        bit = stat.S_IWOTH
    return stat.S_ISDIR(st.st_mode) and bool(st.st_mode & bit) \
        and os.access(path, os.W_OK | os.X_OK)


def build_root() -> Path:
    """The package's `_build/` if it can be created and written, else the
    user cache (module docstring)."""
    own = PACKAGE_BUILD_ROOT
    if _writable(own) or (not own.exists() and _writable(PACKAGE_DIR)):
        return own
    return cache_build_root()


def _roots_tried() -> str:
    return f"build directories: {PACKAGE_BUILD_ROOT} (the package's), then {cache_build_root()}"


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name, path in sources().items():
        h.update(name.encode())
        h.update(path.read_bytes())
    return build_root() / h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def build_all() -> Path:
    """Compile every csrc/*.cu that is not built yet; return the directory.
    The ptxas report of each build is appended to `<dir>/build.log`."""
    out = build_dir()
    todo = {n: p for n, p in sources().items() if not (out / f"{n}.so").is_file()}
    if not todo:
        return out
    try:
        out.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
    except (OSError, RuntimeError) as e:
        raise RuntimeError(f"cannot build the CUDA kernels into {out} ({_roots_tried()}): "
                           f"{e}") from e
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
    """`linsys_kernel<0>` or `nn27_kernel<1,0>` from an Itanium-mangled
    name: the identifier `<len><name>_kernel` whose length prefix matches,
    then its bool template arguments if it has any."""
    for m in re.finditer(r"(?=(\d+)([a-z][a-z0-9_]*?_kernel)(I((?:Lb[01]E)+)E)?)", mangled):
        if int(m.group(1)) == len(m.group(2)):
            flags = ",".join(re.findall(r"Lb([01])E", m.group(4) or ""))
            return m.group(2) + (f"<{flags}>" if flags else "")
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
        raise KeyError(f"no CUDA source {CSRC_DIR / (name + '.cu')} ({_roots_tried()})")
    return ctypes.CDLL(str(build_all() / f"{name}.so"))


def check_device(t, name: str) -> None:
    """Raise unless `t` lies on the CPU (the plain version) or on CUDA (the
    kernel)."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got {t.device}")


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
