"""K1 wrapper: the robust normal equations of one ICP iteration.

CUDA kernel: `csrc/linsys.cu` (replaces the Pallas kernel
`kiss_icp_tpu/ops/pallas_kernels.py::_linsys_kernel`; the source says what
bounds it and what its design does about that). Plain PyTorch version:
`ops/registration.build_linear_system`, taken only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from kiss_icp_tpu_torch.kernels import _build
from kiss_icp_tpu_torch.ops import registration
from kiss_icp_tpu_torch.ops.registration import LinearSystem

_THREADS = 256  # kThreads in csrc/linsys.cu
_MAX_BLOCKS = 1024


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.library("linsys").kiss_linsys
    p = ctypes.c_void_p
    fn.argtypes = [p, p, p, ctypes.c_int, p, p, p, p, ctypes.c_int, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def build_linear_system(
    source: torch.Tensor,
    targets: torch.Tensor,
    weights_mask: torch.Tensor,
    kernel_scale: torch.Tensor,
    center: torch.Tensor,
) -> LinearSystem:
    """(JTJ (6,6), JTr (6,), count ()) of the masked correspondences.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    count one launch in `build_linear_system.launches`), or raise.
    """
    if source.device.type == "cpu":
        return registration.build_linear_system(
            source, targets, weights_mask, kernel_scale, center)
    n = source.shape[0]
    dev = source.device
    _build.check_tensor(source, "source", torch.float32, (n, 3), dev)
    _build.check_tensor(targets, "targets", torch.float32, (n, 3), dev)
    _build.check_tensor(weights_mask, "weights_mask", torch.bool, (n,), dev)
    # The scalars stay on the device: no host read.
    _build.check_tensor(kernel_scale, "kernel_scale", torch.float32, (), dev)
    _build.check_tensor(center, "center", torch.float32, (3,), dev)
    blocks = max(1, min(-(-n // _THREADS), _MAX_BLOCKS))
    partial = torch.empty((blocks, 27), dtype=torch.float32, device=dev)
    partial_count = torch.empty((blocks,), dtype=torch.int32, device=dev)
    jtj = torch.empty((6, 6), dtype=torch.float32, device=dev)
    jtr = torch.empty((6,), dtype=torch.float32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    err = _entry()(
        source.data_ptr(), targets.data_ptr(), weights_mask.data_ptr(), n,
        kernel_scale.data_ptr(), center.data_ptr(), partial.data_ptr(),
        partial_count.data_ptr(), blocks,
        jtj.data_ptr(), jtr.data_ptr(), count.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check_error(err, "linsys kernel")
    build_linear_system.launches += 1
    return LinearSystem(jtj, jtr, count)


build_linear_system.launches = 0
