"""Offline reprocessing, closed loop: `chunk` frames of one drive a call
(`system.chunk`), as the pipeline's chunked driver. The drive restarts from
a fresh state when fewer than `chunk` of its frames are left."""

from __future__ import annotations

import time

from odobench.window import Profiler, Record


def run(system, drives, traffic: dict, seconds: float, prof: Profiler) -> Record:
    scans = drives[0]
    k = int(traffic["chunk"])
    rec = Record()
    t0 = time.perf_counter()
    call, drive, i = 0, 0, 0
    while time.perf_counter() - t0 < seconds:
        if i + k > len(scans):
            system.new_drive()
            drive, i = drive + 1, 0
        prof.before(call)
        poses = system.chunk(scans[i:i + k])
        prof.after(call)
        rec.frames += [(drive, i + j) for j in range(k)]
        rec.poses += list(poses)
        rec.call_frames.append(k)
        call += 1
        i += k
    rec.window_s = time.perf_counter() - t0
    prof.close(call)
    rec.traced_calls = prof.done
    return rec


def warm_up(system, drives, traffic: dict) -> None:
    """`warmup_calls` calls on the drive's first frames, then a fresh state
    for the window."""
    k = int(traffic["chunk"])
    for c in range(int(traffic.get("warmup_calls", 1))):
        system.chunk(drives[0][c * k:(c + 1) * k])
    system.new_drive()
    system.forget()
