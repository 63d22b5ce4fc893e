"""Share of the Gauss-Newton loop's trips that replay a CUDA graph, in
percent: the program's `kiss/gn_replay` spans over its `kiss/gn_trip`
spans (ops/control.py) in the traced calls. A trip that replays nothing
captured its graph (`kiss/gn_capture`: the first trip on a new map) or ran
the Python loop. A program without the replay span gives no reading.
Moves frames_per_s."""

TRIP, REPLAY = "kiss/gn_trip", "kiss/gn_replay"


def read(ctx):
    trips = sum(1 for n, _, _ in ctx.trace.spans if n == TRIP)
    replays = sum(1 for n, _, _ in ctx.trace.spans if n == REPLAY)
    return 100.0 * replays / trips if trips and replays else None
