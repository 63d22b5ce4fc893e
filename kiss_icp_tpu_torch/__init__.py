"""kiss_icp_tpu_torch: the KISS-ICP LiDAR odometry pipeline in PyTorch + CUDA.

A port of `kiss_icp_tpu` (JAX/XLA/Pallas) to PyTorch on an NVIDIA H100. The
module layout mirrors the JAX package so every function has a counterpart of
the same name; the two Pallas kernels become hand-written CUDA C++ kernels
under `csrc/` (`kernels/linsys.py`, `kernels/nn27.py`). This package never
imports JAX or `kiss_icp_tpu`.

Entry points (`odometry.KissICP`, `odometry.init_state`) run on the GPU unless
the caller passes `device="cpu"`, which runs every kernel's plain PyTorch
version instead.
"""

import torch as _torch

# Geometry, not neural nets: every matmul is a small SE(3) transform or a 6x6
# normal-equation contraction whose f32 accuracy is the product. TF32 keeps
# ~3 decimal digits and perturbs 50 m coordinates by centimeters, which makes
# ICP drift (the JAX package forces "highest" matmul precision for the same
# reason). Pin full f32 everywhere.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from kiss_icp_tpu_torch.version import __version__  # noqa: E402

__all__ = ["__version__"]
