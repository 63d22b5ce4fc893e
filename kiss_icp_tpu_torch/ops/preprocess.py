"""Scan preprocessing: motion deskewing + range cropping.

Port of `kiss_icp_tpu/ops/preprocess.py` (reference Preprocessing.cpp:40-95):
  * timestamps are min/max-normalized to [0, 1] over the *valid* points;
  * the per-point pose is `exp((stamp - 1) * log(relative_motion))`, i.e. the
    scan is unwarped toward its END;
  * deskew is skipped when disabled or when the valid stamps do not vary
    (datasets without stamps feed all-zeros);
  * the crop keeps strictly `min_range < |p| < max_range`, which also drops
    non-finite points.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from kiss_icp_tpu_torch.ops import se3


class Preprocessed(NamedTuple):
    points: torch.Tensor  # (N, 3) float32 — deskewed points (padding rows garbage)
    valid: torch.Tensor  # (N,) bool — in-range AND input-valid


def preprocess(
    points: torch.Tensor,
    timestamps: torch.Tensor,
    valid: torch.Tensor,
    relative_motion: torch.Tensor,
    *,
    max_range: float,
    min_range: float,
    deskew: bool,
) -> Preprocessed:
    """Deskew (optional) and range-crop one padded scan.

    Args:
      points: (N, 3) float32 padded scan.
      timestamps: (N,) float32 per-point stamps (any range; normalized here).
      valid: (N,) bool mask of real points.
      relative_motion: (4, 4) last pose delta (constant-velocity prediction).
      deskew: config flag; when False the stamps are ignored entirely.
    """
    if deskew:
        big = torch.finfo(torch.float32).max
        t_min = torch.min(torch.where(valid, timestamps, big))
        t_max = torch.max(torch.where(valid, timestamps, -big))
        span = t_max - t_min
        has_stamps = span > 0.0

        safe_span = torch.where(has_stamps, span, torch.ones_like(span))
        stamps01 = (timestamps - t_min) / safe_span
        omega = se3.se3_log(relative_motion.to(points.dtype))
        # exp(0) = I when the scan has no stamps.
        scale = torch.where(has_stamps, stamps01 - 1.0, torch.zeros_like(stamps01))
        pose_per_point = se3.exp_scaled_batch(omega, scale)  # (N, 4, 4)
        r = pose_per_point[:, :3, :3]
        t = pose_per_point[:, :3, 3]
        deskewed = (r @ points[:, :, None])[:, :, 0] + t
    else:
        deskewed = points

    rng = torch.linalg.norm(deskewed, dim=-1)
    in_range = (rng < max_range) & (rng > min_range)
    return Preprocessed(deskewed, valid & in_range)
