"""K1: the robust normal equations of one ICP iteration, as the operator
`kiss_icp_torch::linsys`.

CUDA kernel: `csrc/linsys.cu` (replaces the Pallas kernel
`kiss_icp_tpu/ops/pallas_kernels.py::_linsys_kernel`; the source says what
bounds it and what its design does about that). One launch per call, with no
scratch memory and no float atomics. The operator's CPU implementation is
the plain PyTorch version, `ops/registration.build_linear_system`; its CUDA
implementation launches the kernel, or raises. A registered operator is what
`torch.export` records, so an exported step calls the same kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from kiss_icp_tpu_torch.kernels import _build
from kiss_icp_tpu_torch.ops import registration
from kiss_icp_tpu_torch.ops.registration import LinearSystem


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.library("linsys").kiss_linsys
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, i, p, p, i, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn, _build.stream_getter()


@torch.library.custom_op("kiss_icp_torch::linsys", mutates_args=(), device_types="cpu")
def linsys(source: torch.Tensor, targets: torch.Tensor, weights_mask: torch.Tensor,
           kernel_scale: torch.Tensor, center: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(JTJ (6,6) f32, JTr (6,) f32, count () i32); on the CPU, the plain
    version."""
    return tuple(registration.build_linear_system(
        source, targets, weights_mask, kernel_scale, center))


@linsys.register_kernel("cuda")
def _linsys_cuda(source, targets, weights_mask, kernel_scale, center):
    """Launch the kernel (one count in `build_linear_system.launches`)."""
    dev = source.device
    fn, stream = _entry()
    n = source.shape[0]
    check = _build.check_tensor
    s_ptr = check(source, "source", torch.float32, (n, 3), dev)
    t_ptr = check(targets, "targets", torch.float32, (n, 3), dev)
    m_ptr = check(weights_mask, "weights_mask", torch.bool, (n,), dev)
    # The scalars stay on the device: no host read.
    k_ptr = check(kernel_scale, "kernel_scale", torch.float32, (), dev)
    c_ptr = check(center, "center", torch.float32, (3,), dev)
    # 16 B loads of the point tiles where the inputs' alignment allows them.
    vec = int(s_ptr % 16 == 0 and t_ptr % 16 == 0 and m_ptr % 4 == 0)
    # Three allocations: on the card's host a view or slice costs about as
    # much as an allocation, so one buffer split into views saves nothing
    # (chip_smoke.py prints both costs).
    jtj = torch.empty((6, 6), dtype=torch.float32, device=dev)
    jtr = torch.empty(6, dtype=torch.float32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    err = fn(s_ptr, t_ptr, m_ptr, n, k_ptr, c_ptr, vec, jtj.data_ptr(), jtr.data_ptr(),
             count.data_ptr(), stream(dev.index))
    _build.check_error(err, "linsys kernel")
    build_linear_system.launches += 1
    return jtj, jtr, count


@linsys.register_fake
def _linsys_fake(source, targets, weights_mask, kernel_scale, center):
    return (source.new_empty((6, 6)), source.new_empty((6,)),
            source.new_empty((), dtype=torch.int32))


def build_linear_system(
    source: torch.Tensor,
    targets: torch.Tensor,
    weights_mask: torch.Tensor,
    kernel_scale: torch.Tensor,
    center: torch.Tensor,
) -> LinearSystem:
    """(JTJ (6,6), JTr (6,), count ()) of the masked correspondences,
    through the operator: the plain version for CPU tensors, the kernel for
    CUDA tensors (counted in `build_linear_system.launches`). Tensors on
    any other device raise."""
    _build.check_device(source, "source")
    return LinearSystem(*linsys(source, targets, weights_mask, kernel_scale, center))


build_linear_system.launches = 0
