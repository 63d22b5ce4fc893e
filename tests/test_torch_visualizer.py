"""The port's visualizer against the JAX package's, with no display.

  * `VisualizerState`: the port's copy and JAX's driven through the same
    event sequences (the controls of tests/test_visualizer_state.py) end in
    the same state and give the same views after every event.
  * `Kissualizer`: the port's viewer under the fake polyscope of
    tests/test_visualizer_gui.py (FakeImgui, FakePolyscope), every control
    driven as that file drives JAX's, the clouds each registers equal to
    JAX's on the same frames.
  * The CLI's `--visualize` runs a drive under that fake; without polyscope
    it raises the JAX viewer's ImportError.
"""

import datetime
import sys

import numpy as np
import pytest
import torch

from kiss_icp_tpu.tools import visualizer_state as jvs
from kiss_icp_tpu_torch.tools import visualizer_state as vs
from tests.test_visualizer_gui import FakeImgui, FakePolyscope, _frame_data, _pose

torch.set_num_threads(1)


def _poses(n=4):
    out = []
    for i in range(n):
        p = np.eye(4)
        c, s = np.cos(0.3 * i), np.sin(0.3 * i)
        p[:2, :2] = [[c, -s], [s, c]]
        p[:3, 3] = [2.0 * i, -1.0 * i, 0.1 * i]
        out.append(p)
    return out


EVENTS = [
    ("frame", 0), ("toggle_play",), ("frame", 1), ("toggle_global_view",), ("frame", 2),
    ("pick_trajectory_pose", 1), ("pick_trajectory_pose", 9), ("toggle_play",),
    ("request_step",), ("set", "show_map", False), ("set", "frame_size", 0.33),
    ("frame", 3), ("toggle_global_view",), ("pick_trajectory_pose", 0), ("request_quit",),
]


def _apply(state, event, poses):
    if event[0] == "frame":
        state.on_new_frame(poses[event[1]], infos={"frame": event[1] + 1, "points": 50,
                                                   "keypoints": 25})
    elif event[0] == "set":
        setattr(state, event[1], event[2])
    else:
        getattr(state, event[0])(*event[1:])


def _snapshot(state):
    views = [state.frame_view(), state.keypoints_view(), state.map_view()]
    return ([(v.transform.tolist(), v.enabled, v.size) for v in views],
            state.trajectory_points().tolist(), state.play_mode, state.global_view,
            state.quit_requested, state.selected_pose, list(state.vis_infos.items()),
            state.show_trajectory, state._step_requested)


def test_state_machine_matches_jax_event_for_event():
    ours, theirs, poses = vs.VisualizerState(), jvs.VisualizerState(), _poses()
    assert _snapshot(ours) == _snapshot(theirs)
    for event in EVENTS:
        _apply(ours, event, poses)
        _apply(theirs, event, poses)
        assert _snapshot(ours) == _snapshot(theirs), event


@pytest.mark.parametrize("stop", ["request_step", "toggle_play", "request_quit", "close"])
def test_blocking_ticks_match_jax(stop):
    counts = []
    for mod in (vs, jvs):
        state, ticks = mod.VisualizerState(), []

        def tick():
            ticks.append(1)
            if len(ticks) % 4 == 0 and stop != "close":
                getattr(state, stop)()

        state.run_blocking_ticks(tick, window_closed=lambda: stop == "close" and len(ticks) >= 3)
        state.run_blocking_ticks(tick)  # in play mode one tick, else blocks again
        counts.append((len(ticks), state.play_mode, state.quit_requested))
    assert counts[0] == counts[1]


def test_constants_and_screenshot_name_match_jax():
    for name in ("FRAME_COLOR", "KEYPOINTS_COLOR", "LOCAL_MAP_COLOR", "TRAJECTORY_COLOR",
                 "BACKGROUND_COLOR", "FRAME_PTS_SIZE", "KEYPOINTS_PTS_SIZE", "MAP_PTS_SIZE"):
        assert getattr(vs, name) == getattr(jvs, name), name
    now = datetime.datetime(2026, 1, 2, 3, 4, 5)
    assert vs.VisualizerState.screenshot_filename(now) == \
        jvs.VisualizerState.screenshot_filename(now)


@pytest.fixture()
def fake_gui(monkeypatch):
    gui = FakeImgui()
    ps = FakePolyscope(gui)
    monkeypatch.setitem(sys.modules, "polyscope", ps)
    monkeypatch.setitem(sys.modules, "polyscope.imgui", gui)
    return ps, gui


@pytest.fixture()
def viz(fake_gui):
    from kiss_icp_tpu_torch.tools.visualizer import Kissualizer

    ps, gui = fake_gui
    return Kissualizer(), ps, gui


def _update(k, pose=None):
    frame, keypoints, odom = _frame_data()
    k.update(frame, keypoints, odom, _pose() if pose is None else pose)
    return frame, keypoints, odom


def test_kissualizer_registers_clouds_and_blocks_until_play(viz):
    k, ps, gui = viz
    assert ps.inited and ps.user_callback is not None and "Visualizer" in ps.program_name
    assert ps.background == k.state.background_color
    ps.on_tick[3] = lambda: gui.pressed_keys.add(gui.ImGuiKey_Space)
    frame, keypoints, odom = _update(k)
    assert ps.ticks == 3 and k.state.play_mode
    assert set(ps.clouds) == {"frame", "keypoints", "local_map"}
    np.testing.assert_array_equal(ps.clouds["frame"].points, frame)
    np.testing.assert_array_equal(ps.clouds["local_map"].points, odom.local_map_points())
    assert any(t.startswith("frame: 1") for t in gui.texts)
    _update(k)
    assert ps.ticks == 4


def test_kissualizer_controls(viz):
    """Step, screenshot, global view with its trajectory, sliders and
    toggles, background, picking, center and quit, as tests/
    test_visualizer_gui.py drives JAX's viewer."""
    k, ps, gui = viz
    ps.on_tick[2] = lambda: gui.clicked_buttons.add("STEP")
    _update(k)
    assert ps.ticks == 2 and not k.state.play_mode

    def shot_edit_play():
        gui.pressed_keys.update({gui.ImGuiKey_S, gui.ImGuiKey_Space})
        gui.slider_edits["##frame_size"] = 0.33
        gui.checkbox_edits["Local Map"] = False
        gui.color_edit = (0.9, 0.8, 0.7)

    ps.on_tick[3] = shot_edit_play
    _update(k, pose=_pose(1.0, 2.0))
    assert len(ps.screenshots) == 1 and ps.screenshots[0].endswith(".jpg")
    assert ps.clouds["frame"].radius == 0.33 and not ps.clouds["local_map"].enabled
    assert ps.background == (0.9, 0.8, 0.7)

    pose = _pose(3.0, 4.0)
    ps.on_tick[4] = lambda: gui.pressed_keys.add(gui.ImGuiKey_G)
    _update(k, pose=pose)
    assert k.state.global_view and ps.camera_resets == 1
    np.testing.assert_array_equal(ps.clouds["frame"].transform, pose)
    assert ps.clouds["trajectory"].points.shape == (3, 3)

    class Pick:
        is_hit = True
        structure_name = "trajectory"
        structure_data = {"index": 1}

    def click():
        gui.io.MouseClicked = [True, False]
        ps.selection = Pick()
        gui.clicked_buttons.add("CENTER")

    ps.on_tick[5] = click
    _update(k, pose=_pose(5.0, 6.0))
    assert "1.000" in k.state.selected_pose and ps.camera_resets == 2
    ps.on_tick[6] = lambda: gui.pressed_keys.add(gui.ImGuiKey_Q)
    with pytest.raises(SystemExit):
        _update(k)
    assert ps.unshown


def test_kissualizer_shows_what_jax_shows(fake_gui):
    """The same frames through both viewers: the same clouds, transforms,
    sizes and trajectory."""
    from kiss_icp_tpu.tools.visualizer import Kissualizer as JaxKissualizer
    from kiss_icp_tpu_torch.tools.visualizer import Kissualizer

    ps, gui = fake_gui
    seen = []
    for cls in (Kissualizer, JaxKissualizer):
        ps.clouds.clear()
        k = cls()
        k.state.play_mode = True
        k.state.global_view = True
        for pose in _poses(3):
            frame, keypoints, odom = _frame_data()
            k.update(frame, keypoints, odom, pose)
        seen.append({name: (c.points.tolist(), c.transform.tolist(), c.radius, c.enabled,
                            c.color) for name, c in ps.clouds.items()})
    assert seen[0] == seen[1] and set(seen[0]) == {"frame", "keypoints", "local_map",
                                                   "trajectory"}


def test_missing_polyscope_raises_importerror(monkeypatch):
    for name in ("polyscope", "polyscope.imgui"):
        monkeypatch.setitem(sys.modules, name, None)
    from kiss_icp_tpu.tools.visualizer import Kissualizer as JaxKissualizer
    from kiss_icp_tpu_torch.tools.visualizer import Kissualizer

    with pytest.raises(ImportError, match="polyscope") as ours:
        Kissualizer()
    with pytest.raises(ImportError) as theirs:
        JaxKissualizer()
    assert str(ours.value) == str(theirs.value)


def _scan_dir(tmp_path, n=3):
    rng = np.random.default_rng(0)
    base = rng.uniform(-30, 30, (2000, 3)).astype(np.float32)
    for i in range(n):
        pts = base + np.float32([0.3 * i, 0.0, 0.0])
        np.hstack([pts, np.zeros((2000, 1), np.float32)]).tofile(tmp_path / f"{i:06d}.bin")


def _cli_config(tmp_path):
    from kiss_icp_tpu_torch.config.parser import load_config, write_config

    cfg = load_config(None)
    cfg.out_dir = str(tmp_path / "results")
    cfg.data.max_range = 50.0
    cfg.data.min_range = 1.0
    cfg.mapping.voxel_size = 0.5
    cfg.engine.max_points_per_frame = 2048
    cfg.engine.frame_capacity = 2048
    cfg.engine.source_capacity = 512
    cfg.engine.map_capacity_log2 = 13
    write_config(cfg, tmp_path / "cfg.yml")
    return tmp_path / "cfg.yml"


def test_cli_visualize_runs_the_drive_under_the_fake(fake_gui, tmp_path):
    from kiss_icp_tpu_torch.tools import cmd

    ps, gui = fake_gui
    data = tmp_path / "scans"
    data.mkdir()
    _scan_dir(data)
    ps.on_tick[1] = lambda: gui.pressed_keys.add(gui.ImGuiKey_Space)  # play
    rc = cmd.main([str(data), "--visualize", "--device", "cpu",
                   "--config", str(_cli_config(tmp_path))])
    assert rc == 0
    assert ps.inited and ps.ticks == 3  # one tick a frame once playing
    assert set(ps.clouds) >= {"frame", "keypoints", "local_map"}
    assert len(ps.clouds["local_map"].points) > 0
    assert any(t.startswith("frame: 3") for t in gui.texts)
    assert list((tmp_path / "results").glob("*/*_poses.npy"))


def test_cli_visualize_without_polyscope_raises(monkeypatch, tmp_path):
    from kiss_icp_tpu_torch.tools import cmd

    for name in ("polyscope", "polyscope.imgui"):
        monkeypatch.setitem(sys.modules, name, None)
    _scan_dir(tmp_path)
    with pytest.raises(ImportError, match="drop --visualize"):
        cmd.main([str(tmp_path), "--visualize", "--device", "cpu"])
