"""The port's profiler spans: named host intervals that cost nothing unless
a profiler runs.

Every span is a `torch.profiler.record_function`, so it lands in the same
trace, on the same clock, as the kernels and copies the profiler records on
the card. Without a profiler a `record_function` still enters a dispatcher
op (~13 us on a CPU host); `span` reads the profiler's own flag first and
then returns one shared no-op context instead (~0.15 us). Under
`torch.export` or `torch.compile` no span is entered, so an exported
program holds no profiler op.

The names (tools/profile_drive.py, tools/op_breakdown.py and the
benchmark's readers take them from the trace):

  * `kiss/<stage>`: the step's stages (`kiss/frame` around a whole frame,
    `kiss/preprocess`, `kiss/downsample`, `kiss/threshold`, `kiss/align`,
    `kiss/solve`, `kiss/map_insert`, `kiss/map_trim`, ...) and the host
    wrapper's (`kiss/pack`: padding scans into a host buffer; `kiss/h2d`:
    moving it to the device);
  * `kiss/<loop>_trip`: one trip of an `ops/control.py` loop, from the read
    that let it run up to the next read; inside it, where the trip runs on
    a CUDA graph, `kiss/<loop>_capture` (the trip that captures it) or
    `kiss/<loop>_replay` (each later trip): a replayed trip enters none of
    the body's spans (`kiss/solve`); likewise `kiss/map_capture` or
    `kiss/map_replay` inside `kiss/map_insert`, where a step's whole map
    update, trim included, runs on one CUDA graph (ops/hash_map.py
    `update`);
  * `kiss/sync/<site>`: a host read of a device value (`read`), in which
    the host waits for the device.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def enabled() -> bool:
    """True while a profiler records and no trace (`torch.export`,
    `torch.compile`) is running."""
    return _profiler._is_profiler_enabled and not torch.compiler.is_compiling()


def span(name: str):
    """A context that records `name` as a profiler span while a profiler
    runs, and does nothing otherwise."""
    return _profiler.record_function(name) if enabled() else _OFF


def read(site: str, fn: Callable, *args):
    """`fn(*args)`, a host read of a device value (`bool`, `.cpu()`,
    `torch.nonzero`), inside the span `kiss/sync/<site>`."""
    if not enabled():
        return fn(*args)
    with _profiler.record_function(f"kiss/sync/{site}"):
        return fn(*args)


def spanned(name: str):
    """A decorator: the function runs inside `span(name)`."""
    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return run
    return wrap
