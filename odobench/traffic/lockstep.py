"""`rows` sequences in lockstep, closed loop: one frame of each a call
(`system.step_rows`). All rows restart from a fresh state when the shortest
drive runs out; a frame's drive is then (pass, row): pass * rows + row."""

from __future__ import annotations

import time

from odobench.window import Profiler, Record


def run(system, drives, traffic: dict, seconds: float, prof: Profiler) -> Record:
    rows = len(drives)
    n = min(len(d) for d in drives)
    rec = Record()
    t0 = time.perf_counter()
    call, drive, i = 0, 0, 0
    while time.perf_counter() - t0 < seconds:
        if i >= n:
            system.new_drive()
            drive, i = drive + 1, 0
        prof.before(call)
        poses = system.step_rows([d[i] for d in drives])
        prof.after(call)
        rec.frames += [(drive * rows + b, i) for b in range(rows)]
        rec.poses += list(poses)
        rec.call_frames.append(rows)
        call += 1
        i += 1
    rec.window_s = time.perf_counter() - t0
    prof.close(call)
    rec.traced_calls = prof.done
    return rec


def warm_up(system, drives, traffic: dict) -> None:
    """`warmup_calls` steps on the drives' first frames, then a fresh state
    for the window."""
    for c in range(int(traffic.get("warmup_calls", 1))):
        system.step_rows([d[c] for d in drives])
    system.new_drive()
    system.forget()
