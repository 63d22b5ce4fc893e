"""The traced window, reduced: device operations, host spans, idle gaps.

Reads `torch.profiler`'s event list (CPU and CUDA activities). Device
events are kernels, copies and fills on the card; the profiler's GPU-side
copies of host spans are left out. Host spans are the program's `kiss/*`
stages and the benchmark's own `odobench/*` spans around each call into
the program.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

SPAN_PREFIXES = ("kiss/", "odobench/")


@dataclass
class Trace:
    # (name, start us, duration us) of every device operation, by start.
    device: List[Tuple[str, float, float]] = field(default_factory=list)
    # (name, start us, end us) of every host span, by start.
    spans: List[Tuple[str, float, float]] = field(default_factory=list)

    def span_us(self, *names: str) -> float:
        return sum(e - s for n, s, e in self.spans if n in names)

    def spans_with_prefix(self, prefix: str) -> List[Tuple[str, float, float]]:
        return [sp for sp in self.spans if sp[0].startswith(prefix)]

    def calls(self) -> List[Tuple[str, float, float]]:
        """The benchmark's spans around its calls into the program."""
        return self.spans_with_prefix("odobench/")

    def kernels(self) -> List[Tuple[str, float, float]]:
        return [d for d in self.device if not d[0].startswith(("Memcpy", "Memset"))]

    def busy_us(self) -> float:
        """Device busy time: the union of the device operations' intervals."""
        busy, end = 0.0, float("-inf")
        for _, s, d in self.device:
            e = s + d
            if e <= end:
                continue
            busy += e - max(s, end)
            end = e
        return busy

    def window_us(self) -> float:
        calls = self.calls()
        if not calls:
            return 0.0
        return max(e for _, _, e in calls) - min(s for _, s, _ in calls)

    def calls_us(self) -> float:
        return sum(e - s for _, s, e in self.calls())

    def top_device_ops(self, n: int = 10) -> List[List]:
        tot: Dict[str, float] = {}
        for name, _, d in self.device:
            tot[name] = tot.get(name, 0.0) + d
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], us / 1e6] for name, us in top]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The longest gaps between device operations inside the benchmark's
        calls, each named by the innermost span the host was in at the
        gap's middle."""
        calls = self.calls()
        if not self.device or not calls:
            return []
        lo = min(s for _, s, _ in calls)
        hi = max(e for _, _, e in calls)
        gaps, end = [], lo
        for _, s, d in self.device:
            if s > end and s <= hi:
                gaps.append((s - end, end, s))
            end = max(end, s + d)
        if hi > end:
            gaps.append((hi - end, end, hi))
        starts = [s for _, s, _ in self.spans]
        out = []
        for length, s, e in sorted(gaps, reverse=True)[:n]:
            mid = 0.5 * (s + e)
            name, best = "outside any span", None
            for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
                sn, ss, se = self.spans[i]
                if ss <= mid < se and (best is None or se - ss < best):
                    name, best = sn, se - ss
            out.append([name, length / 1e6])
        return out


def reduce_events(events) -> Trace:
    """A `Trace` of a profiler's `events()`."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    tr = Trace()
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            if getattr(e, "is_user_annotation", False) or e.name.startswith(SPAN_PREFIXES):
                continue
            tr.device.append((e.name, float(start), float(end - start)))
        elif e.name.startswith(SPAN_PREFIXES):
            tr.spans.append((e.name, float(start), float(end)))
    tr.device.sort(key=lambda d: d[1])
    tr.spans.sort(key=lambda sp: sp[1])
    return tr
