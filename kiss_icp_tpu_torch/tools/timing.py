"""Device and eager time per call of a function on the card.

Shared by `chip_smoke.py` and `tools/kernel_anatomy.py`, so that every
kernel time in PERF.md is taken the same way.
"""

from __future__ import annotations

import torch


def events_ms(run, calls: int) -> float:
    """ms per call of `run()`, which makes `calls` calls, by CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def time_ms(fn, reps: int):
    """(device ms, eager ms) per call of `fn`. Device: `reps` calls captured
    in one CUDA graph, replayed, so no host work sits between launches.
    Eager: `reps` calls issued from Python, as the main path issues them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture stream
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    device = events_ms(lambda: [graph.replay() for _ in range(3)], 3 * reps)
    eager = events_ms(lambda: [fn() for _ in range(reps)], reps)
    return device, eager
