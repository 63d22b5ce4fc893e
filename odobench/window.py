"""What the traffic drivers share: the record of a window and its tracer.

A traffic mix is a data file, `odobench/traffic/<mix>.json`, whose key
"driver" names a module of the same folder, `odobench/traffic/<driver>.py`.
The module exports `run(system, drives, traffic, seconds, prof) -> Record`
and `warm_up(system, drives, traffic)`; the harness loads it by name.

A window starts with the first call and ends when the call in flight at
`seconds` returns. A drive that runs out restarts from a fresh state.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np


@dataclass
class Record:
    """What a window did: every frame as (drive, frame index) with its pose
    on the host, in call order, and the calls' frame counts."""

    frames: List[Tuple[int, int]] = field(default_factory=list)
    poses: List[np.ndarray] = field(default_factory=list)
    call_frames: List[int] = field(default_factory=list)
    window_s: float = 0.0
    traced_calls: Tuple[int, int] = (0, 0)

    def traced_frames(self) -> List[int]:
        """Positions in `frames` of the frames the traced calls registered."""
        a, b = self.traced_calls
        start = sum(self.call_frames[:a])
        return list(range(start, start + sum(self.call_frames[a:b])))


class Profiler:
    """Traces the calls [first, first + count) of a window with
    torch.profiler (CPU and CUDA), or nothing when `count` is 0."""

    def __init__(self, first: int, count: int):
        self.first, self.count = int(first), int(count)
        self.prof = None
        self.events = None
        self.done = (0, 0)

    def before(self, call: int) -> None:
        if self.count and call == self.first:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()

    def after(self, call: int) -> None:
        if self.prof is not None and call == self.first + self.count - 1:
            self._stop(call + 1)

    def close(self, calls: int) -> None:
        """End a trace that the window's end cut short."""
        if self.prof is not None:
            self._stop(calls)

    def _stop(self, end: int) -> None:
        self.prof.stop()
        self.events = self.prof.events()
        self.prof = None
        self.done = (self.first, end)
