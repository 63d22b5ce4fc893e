"""Control state machine of the interactive visualizer, GUI-free.

A copy of the JAX package's `tools/visualizer_state.py` (numpy only), held
to it event for event by tests/test_torch_visualizer.py.

The reference implements play/pause/step/screenshot/global-local view/center/
quit directly inside polyscope imgui callbacks (reference
tools/visualizer.py:167-296), which makes the logic untestable without a
display. Here every decision lives in `VisualizerState` — the GUI shell
(`visualizer.Kissualizer`) only forwards button/key events to these methods
and applies the returned transforms, so the whole control surface is unit
tested headless.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

# Cloud render defaults (sizes in meters; colors RGB 0-1).
FRAME_COLOR = (0.53, 0.65, 1.0)
KEYPOINTS_COLOR = (1.0, 0.45, 0.0)
LOCAL_MAP_COLOR = (0.7, 0.7, 0.7)
TRAJECTORY_COLOR = (1.0, 0.0, 0.0)
BACKGROUND_COLOR = (0.1, 0.1, 0.1)
FRAME_PTS_SIZE = 0.06
KEYPOINTS_PTS_SIZE = 0.2
MAP_PTS_SIZE = 0.08


@dataclass
class CloudViewSpec:
    """What the GUI must apply to one registered cloud this frame."""

    transform: np.ndarray  # (4, 4) polyscope structure transform
    enabled: bool
    size: float


@dataclass
class VisualizerState:
    """All mutable control state + the view math, no GUI dependency.

    View semantics (matching the reference's global/local modes):
      * local (egocentric) view — frame/keypoints stay at the origin (the
        sensor), the map is moved by pose^-1 into the sensor frame;
      * global view — frame/keypoints are placed at the world pose, the map
        stays in world coordinates, and the trajectory is shown.
    """

    play_mode: bool = False
    global_view: bool = False
    show_frame: bool = True
    show_keypoints: bool = True
    show_map: bool = True
    frame_size: float = FRAME_PTS_SIZE
    keypoints_size: float = KEYPOINTS_PTS_SIZE
    map_size: float = MAP_PTS_SIZE
    background_color: tuple = BACKGROUND_COLOR
    quit_requested: bool = False
    trajectory: List[np.ndarray] = field(default_factory=list)
    last_pose: np.ndarray = field(default_factory=lambda: np.eye(4))
    vis_infos: Dict[str, object] = field(default_factory=dict)
    selected_pose: str = ""
    _step_requested: bool = field(default=False, repr=False)

    # --- per-frame data ---------------------------------------------------
    def on_new_frame(self, pose: np.ndarray, infos: Optional[dict] = None):
        pose = np.asarray(pose, dtype=np.float64)
        self.last_pose = pose
        self.trajectory.append(pose[:3, 3].copy())
        if infos is not None:
            # Stable presentation order (short labels first, like the ref).
            self.vis_infos = dict(sorted(infos.items(), key=lambda kv: len(kv[0])))

    # --- view math --------------------------------------------------------
    def frame_view(self) -> CloudViewSpec:
        t = self.last_pose if self.global_view else np.eye(4)
        return CloudViewSpec(t, self.show_frame, self.frame_size)

    def keypoints_view(self) -> CloudViewSpec:
        t = self.last_pose if self.global_view else np.eye(4)
        return CloudViewSpec(t, self.show_keypoints, self.keypoints_size)

    def map_view(self) -> CloudViewSpec:
        t = np.eye(4) if self.global_view else np.linalg.inv(self.last_pose)
        return CloudViewSpec(t, self.show_map, self.map_size)

    @property
    def show_trajectory(self) -> bool:
        return self.global_view

    def trajectory_points(self) -> np.ndarray:
        return (
            np.asarray(self.trajectory)
            if self.trajectory
            else np.zeros((0, 3), np.float64)
        )

    # --- control actions (bound to buttons / keys by the GUI shell) -------
    def toggle_play(self):
        self.play_mode = not self.play_mode

    def request_step(self):
        """Advance exactly one frame while paused."""
        if not self.play_mode:
            self._step_requested = True

    def toggle_global_view(self):
        self.global_view = not self.global_view

    def request_quit(self):
        self.quit_requested = True

    def pick_trajectory_pose(self, index: int):
        if 0 <= index < len(self.trajectory):
            p = self.trajectory[index]
            self.selected_pose = f"x: {p[0]:7.3f}, y: {p[1]:7.3f}, z: {p[2]:7.3f}"
        else:
            self.selected_pose = ""

    @staticmethod
    def screenshot_filename(now: Optional[datetime.datetime] = None) -> str:
        now = now or datetime.datetime.now()
        return "kiss_icp_tpu_" + now.strftime("%Y-%m-%d_%H-%M-%S") + ".jpg"

    # --- blocking-tick loop ----------------------------------------------
    def run_blocking_ticks(self, tick, window_closed=None) -> None:
        """Drive the GUI event loop until the pipeline may advance one frame.

        `tick()` renders one GUI frame (polyscope frame_tick). Returns
        immediately in play mode; while paused, loops until `request_step`,
        `toggle_play`, or `request_quit` is triggered from inside a tick —
        or `window_closed()` reports the user closed the OS window (the
        title-bar X fires no ImGui callback, so without this check a paused
        session would spin forever on a close-requested window).
        """
        if self.play_mode:
            tick()
            # The title-bar X fires no ImGui callback in play mode either:
            # without this check a playing session ignores the OS close
            # request until pause/quit (code-review r4d).
            if window_closed is not None and window_closed():
                self.request_quit()
            return
        self._step_requested = False
        while not (self.play_mode or self._step_requested or self.quit_requested):
            tick()
            if window_closed is not None and window_closed():
                self.request_quit()
