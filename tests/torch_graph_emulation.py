"""CUDA graphs emulated on the CPU (ops/control.py), for the tests that
hold the graph paths to the live ones without a card.

`emulate(monkeypatch)` sends every loop and call that gives a graph key
down its graph path, as on the card: `control.uses_graph` holds for CPU
tensors outside a trace, and each capture (`control.Graph._record`) runs
the graph's work once in Python, as the capture's eager run does, while
each replay runs it again on the graph's own buffers. Returns a Counter of
`<class>.capture` and `<class>.replay` (`TripGraph`, `CallGraph`). Imports
no JAX.
"""

from __future__ import annotations

import collections
from types import SimpleNamespace


def emulate(monkeypatch) -> collections.Counter:
    from kiss_icp_tpu_torch.ops import control

    events = collections.Counter()

    def record(self, run, dev):
        kind = type(self).__name__
        events[f"{kind}.capture"] += 1
        run()

        def replay():
            events[f"{kind}.replay"] += 1
            run()

        self.parts, self.launched = [SimpleNamespace(replay=replay)], ()

    control.clear_graphs()
    monkeypatch.setattr(control, "uses_graph",
                        lambda carry, key: key is not None and not control.tracing())
    monkeypatch.setattr(control.Graph, "_record", record)
    return events
