"""Adaptive correspondence threshold as three device scalars.

Port of `kiss_icp_tpu/ops/threshold.py` (reference Threshold.{hpp:29-47,
cpp:30-51}): the running sum of squared model errors is Kahan-compensated in
two f32 scalars (the reference sums in f64), and a diverged frame's model
error is clamped to 1e3 m so one bad frame cannot poison every later sigma.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from kiss_icp_tpu_torch.ops import se3


class ThresholdState(NamedTuple):
    model_sse: torch.Tensor  # () float32 — running sum of squared model errors
    sse_comp: torch.Tensor  # () float32 — Kahan compensation of model_sse
    num_samples: torch.Tensor  # () float32 — sample count (float for the division)


def init_state(initial_threshold: float, device=None) -> ThresholdState:
    """model_sse = initial^2, num_samples = 1 (reference Threshold.cpp:30-36)."""
    f32 = dict(dtype=torch.float32, device=device)
    return ThresholdState(
        model_sse=torch.tensor(initial_threshold * initial_threshold, **f32),
        sse_comp=torch.zeros((), **f32),
        num_samples=torch.tensor(1.0, **f32),
    )


def compute_threshold(state: ThresholdState) -> torch.Tensor:
    """sigma = sqrt(model_sse / num_samples) (reference Threshold.hpp:38)."""
    return torch.sqrt(state.model_sse / state.num_samples)


def update_model_deviation(
    state: ThresholdState,
    model_deviation: torch.Tensor,
    *,
    max_range: float,
    min_motion_th: float,
) -> ThresholdState:
    """Accumulate the model error of one frame (reference Threshold.cpp:38-49).

    model_error = |t| + 2 * max_range * sin(theta / 2), accumulated only when
    it exceeds `min_motion_th`.
    """
    theta = se3.rotation_angle(model_deviation[:3, :3])
    delta_rot = 2.0 * max_range * torch.sin(theta / 2.0)
    delta_trans = torch.linalg.norm(model_deviation[:3, 3])
    # Clamp: f32 overflows where the reference's f64 does not; 1e3 m of
    # per-frame model error is already far beyond recoverable.
    model_error = torch.clamp(
        torch.nan_to_num(delta_trans + delta_rot, nan=1e3, posinf=1e3), max=1e3)
    moved = model_error > min_motion_th
    zero = torch.zeros_like(model_error)
    increment = torch.where(moved, model_error * model_error, zero)
    # Kahan-compensated accumulation.
    y = increment - state.sse_comp
    t = state.model_sse + y
    comp = (t - state.model_sse) - y
    return ThresholdState(
        model_sse=t,
        sse_comp=torch.where(torch.isfinite(comp), comp, zero),
        num_samples=state.num_samples + moved.to(torch.float32),
    )
