"""Visualizers: the no-op stub the pipeline runs headless with.

The JAX package's interactive polyscope viewer (`Kissualizer`) and its
GUI-free state machine are not ported yet (ROADMAP item 17b); the CLI's
`--visualize` refuses to run until they are.
"""

from __future__ import annotations


class StubVisualizer:
    """No-op visualizer (reference tools/visualizer.py:52-57)."""

    def update(self, frame, keypoints, odometry, pose):
        pass
