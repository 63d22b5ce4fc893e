"""`correct` rejects the control and the faults the cells can have, and
accepts the port, on the CPU at a small size (the chip's readings and the
limits are in PERF.md).

The control is the reference in TF32 in the program's place
(`reference/control.py`). The faults are planted in the port's timed path:
a step that keeps its state's pose; the same on every other frame; the
batch's rows from B / 2 on left out of the step (their state kept); half of
the correspondences left out of the normal equations, the solve taken over
the rest; every answer moved by 2 cm where ICP produces it. One chip, so no
exchange between chips to leave out.
"""

import pytest
import torch

from odobench.harness import run_cell
from odobench.reference.control import Control
from odobench.tests.tiny import make_root

CELLS = ["tiny.tiny_offline", "tiny.tiny_batch"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return make_root(tmp_path_factory.mktemp("odobench"))


def _run(root, cell, **kw):
    # Long enough for a second lockstep call on a loaded CPU: its first
    # call registers only frame 0, which the check does not compare.
    return run_cell(cell, 2**32 + 77, 2.0, False, device="cpu", root=root,
                    log=lambda s: None, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_the_port_is_correct(root, cell):
    assert _run(root, cell)["correct"] is True


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_rejected(root, cell):
    r = _run(root, cell, system_factory=Control)
    assert r["correct"] is False
    assert r["checks"]["pose_gap_median_m"]["value"] > r["checks"]["pose_gap_median_m"]["limit"]


def _unchanged(monkeypatch):
    from kiss_icp_tpu_torch import odometry

    real = odometry._finish_frame

    def keep_pose(config, state, prep, frame_ds, source, sigma, guess, new_pose, *rest, **kw):
        return real(config, state, prep, frame_ds, source, sigma, guess, state.pose, *rest, **kw)

    monkeypatch.setattr(odometry, "_finish_frame", keep_pose)


def _every_other(monkeypatch):
    from kiss_icp_tpu_torch import odometry

    real, calls = odometry._finish_frame, [0]

    def keep_pose(config, state, prep, frame_ds, source, sigma, guess, new_pose, *rest, **kw):
        calls[0] += 1
        pose = state.pose if calls[0] % 2 else new_pose
        return real(config, state, prep, frame_ds, source, sigma, guess, pose, *rest, **kw)

    monkeypatch.setattr(odometry, "_finish_frame", keep_pose)


def _rows_left_out(monkeypatch):
    from kiss_icp_tpu_torch import odometry

    real = odometry.store_rows

    def store_first_half(state, rows):
        half = (len(rows) + 1) // 2
        kept = [odometry.state_row(state, b) for b in range(half, len(rows))]
        return real(state, list(rows[:half]) + kept)

    monkeypatch.setattr(odometry, "store_rows", store_first_half)


def _half_batch(monkeypatch):
    from kiss_icp_tpu_torch.kernels import linsys

    def halve(mask):
        keep = torch.arange(mask.shape[-1], device=mask.device) < mask.shape[-1] // 2
        return mask & keep

    one, many = linsys.build_linear_system, linsys.build_linear_systems
    monkeypatch.setattr(linsys, "build_linear_system",
                        lambda s, t, m, *a, **k: one(s, t, halve(m), *a, **k))
    monkeypatch.setattr(linsys, "build_linear_systems",
                        lambda s, t, m, *a, **k: many(s, t, halve(m), *a, **k))


def _altered(monkeypatch):
    from kiss_icp_tpu_torch.ops import registration

    def moved(fn):
        def run(*a, **k):
            out = fn(*a, **k)
            pose = out.pose.clone()
            pose[..., 0, 3] += 0.02
            return out._replace(pose=pose)
        return run

    monkeypatch.setattr(registration, "align_points_to_map",
                        moved(registration.align_points_to_map))
    monkeypatch.setattr(registration, "align_lockstep", moved(registration.align_lockstep))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _every_other, _half_batch, _altered],
                         ids=["state_unchanged", "every_other_frame", "half_batch",
                              "answer_altered"])
def test_a_fault_is_rejected(root, cell, fault, monkeypatch):
    fault(monkeypatch)
    assert _run(root, cell)["correct"] is False


def test_rows_left_out_are_rejected(root, monkeypatch):
    """Rows 3 and 4 of the tiny batch's 5 keep their state: fewer than half
    of the checked frames are off, so the median passes and the share of
    frames off by more than 5 cm does not."""
    _rows_left_out(monkeypatch)
    r = _run(root, "tiny.tiny_batch")
    median, over = r["checks"]["pose_gap_median_m"], r["checks"]["frames_over_5cm_pct"]
    assert r["correct"] is False
    assert median["value"] <= median["limit"] and over["value"] > over["limit"]
