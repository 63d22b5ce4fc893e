"""Visualizers: a no-op stub and an optional interactive 3D viewer.

Port of the JAX package's `tools/visualizer.py`: the viewer is numpy and
polyscope on the host, so the port's copy differs only in its imports; the
point clouds it shows come from the port's engine (`local_map_points()`).

The reference ships a polyscope/imgui visualizer (tools/visualizer.py:52-299)
behind an optional extra. polyscope is not part of this environment, so the
interactive implementation is gated behind a lazy import. Its full control
surface — play/pause (space), single-step (N), screenshot (S), global/local
view (G), center viewpoint (C), quit (Q/Esc), per-cloud size sliders and
toggles, background color, odometry info panel, trajectory picking — is
implemented as event bindings over the GUI-free `VisualizerState` machine
(`visualizer_state.py`), which carries all the logic and is unit-tested
headless. The stub preserves the `update()` contract so the pipeline is
identical with or without a viewer.
"""

from __future__ import annotations

import numpy as np

from kiss_icp_tpu_torch.tools.visualizer_state import VisualizerState


class StubVisualizer:
    """No-op visualizer (reference tools/visualizer.py:52-57)."""

    def update(self, frame, keypoints, odometry, pose):
        pass


class Kissualizer(StubVisualizer):
    """Interactive polyscope viewer driven by a `VisualizerState` machine."""

    def __init__(self):
        try:
            import polyscope as ps
            import polyscope.imgui as gui
        except ImportError as e:
            raise ImportError(
                "polyscope is required for the interactive visualizer; "
                "install it or drop --visualize"
            ) from e
        self._ps = ps
        self._gui = gui
        self.state = VisualizerState()
        ps.set_program_name("KISS-ICP-TPU Visualizer")
        ps.init()
        ps.set_ground_plane_mode("none")
        ps.set_background_color(list(self.state.background_color))
        ps.set_verbosity(0)
        ps.set_user_callback(self._gui_callback)
        ps.set_build_default_gui_panels(False)

    # --- pipeline hook ----------------------------------------------------
    def update(self, frame, keypoints, odometry, pose):
        from kiss_icp_tpu_torch.tools import visualizer_state as vs

        st = self.state
        st.on_new_frame(
            pose,
            infos={
                "frame": len(st.trajectory) + 1,
                "points": len(np.asarray(frame)),
                "keypoints": len(np.asarray(keypoints)),
            },
        )

        ps = self._ps
        clouds = {
            "frame": (np.asarray(frame), vs.FRAME_COLOR, st.frame_view()),
            "keypoints": (np.asarray(keypoints), vs.KEYPOINTS_COLOR,
                          st.keypoints_view()),
            "local_map": (odometry.local_map_points(), vs.LOCAL_MAP_COLOR,
                          st.map_view()),
        }
        for name, (pts, color, view) in clouds.items():
            cloud = ps.register_point_cloud(
                name, pts, color=color, point_render_mode="quad"
            )
            cloud.set_radius(view.size, relative=False)
            cloud.set_transform(view.transform)
            cloud.set_enabled(view.enabled)
        self._sync_trajectory()

        st.run_blocking_ticks(
            ps.frame_tick,
            window_closed=getattr(ps, "window_requests_close", None),
        )
        if st.quit_requested:
            ps.unshow()
            raise SystemExit(0)

    def _sync_trajectory(self):
        from kiss_icp_tpu_torch.tools import visualizer_state as vs

        ps, st = self._ps, self.state
        if st.show_trajectory and len(st.trajectory):
            # Re-upload only when something changed: _apply_view runs on
            # every GUI tick, and while paused that would re-register the
            # whole (N, 3) trajectory cloud each rendered frame for zero
            # visual change.
            sig = (len(st.trajectory), True)
            if getattr(self, "_traj_sig", None) != sig:
                traj = ps.register_point_cloud(
                    "trajectory", st.trajectory_points(),
                    color=vs.TRAJECTORY_COLOR,
                )
                traj.set_radius(0.3, relative=False)
                self._traj_sig = sig
        elif ps.has_point_cloud("trajectory"):
            ps.remove_point_cloud("trajectory")
            self._traj_sig = None

    def _apply_view(self):
        """Push the state's per-cloud transforms/sizes onto live structures."""
        ps, st = self._ps, self.state
        for name, view in (
            ("frame", st.frame_view()),
            ("keypoints", st.keypoints_view()),
            ("local_map", st.map_view()),
        ):
            if ps.has_point_cloud(name):
                c = ps.get_point_cloud(name)
                c.set_transform(view.transform)
                c.set_radius(view.size, relative=False)
                c.set_enabled(view.enabled)
        self._sync_trajectory()

    # --- imgui callback ---------------------------------------------------
    def _gui_callback(self):
        gui, st = self._gui, self.state

        # Shortcuts must not fire while a text widget has focus (typing 'q'
        # into the background-color hex field would otherwise QUIT mid-run).
        def pressed(k):
            return (not gui.GetIO().WantTextInput) and gui.IsKeyPressed(k)

        # Play / pause / step / screenshot row.
        if gui.Button("PAUSE" if st.play_mode else "PLAY") or pressed(
            gui.ImGuiKey_Space
        ):
            st.toggle_play()
        if not st.play_mode:
            gui.SameLine()
            if gui.Button("STEP") or pressed(gui.ImGuiKey_N):
                st.request_step()
        gui.SameLine()
        if gui.Button("SCREENSHOT") or pressed(gui.ImGuiKey_S):
            self._ps.screenshot(st.screenshot_filename())
        gui.Separator()

        # Odometry info panel.
        if gui.TreeNodeEx("Odometry Information",
                          gui.ImGuiTreeNodeFlags_DefaultOpen):
            for label, value in st.vis_infos.items():
                gui.TextUnformatted(f"{label}: {value}")
            if not st.play_mode and st.global_view and st.selected_pose:
                gui.TextUnformatted(f"Selected Pose: {st.selected_pose}")
            gui.TreePop()
        gui.Separator()

        # Cloud sliders + toggles.
        for label, size_attr, show_attr in (
            ("Frame Cloud", "frame_size", "show_frame"),
            ("Keypoints", "keypoints_size", "show_keypoints"),
            ("Local Map", "map_size", "show_map"),
        ):
            changed, value = gui.SliderFloat(
                f"##{size_attr}", getattr(st, size_attr), v_min=0.01, v_max=0.6
            )
            if changed:
                setattr(st, size_attr, value)
            gui.SameLine()
            changed, value = gui.Checkbox(label, getattr(st, show_attr))
            if changed:
                setattr(st, show_attr, value)
        changed, color = gui.ColorEdit3("Background", list(st.background_color))
        if changed:
            st.background_color = tuple(color)
            self._ps.set_background_color(list(color))

        # View controls.
        if gui.Button("LOCAL VIEW" if st.global_view else "GLOBAL VIEW") or (
            pressed(gui.ImGuiKey_G)
        ):
            st.toggle_global_view()
            self._ps.reset_camera_to_home_view()
        gui.SameLine()
        if gui.Button("CENTER") or pressed(gui.ImGuiKey_C):
            self._ps.reset_camera_to_home_view()
        gui.Separator()
        if (
            gui.Button("QUIT")
            or pressed(gui.ImGuiKey_Q)
            or pressed(gui.ImGuiKey_Escape)
        ):
            st.request_quit()

        # Trajectory pose picking (only meaningful in global view). Clicks
        # the GUI itself consumes (buttons, sliders) must not clear the
        # selection — only scene clicks count.
        if gui.GetIO().MouseClicked[0] and not gui.GetIO().WantCaptureMouse:
            pick = self._ps.get_selection()
            if getattr(pick, "is_hit", True) and \
                    pick.structure_name == "trajectory":
                st.pick_trajectory_pose(int(pick.structure_data["index"]))
            else:
                st.selected_pose = ""

        self._apply_view()
