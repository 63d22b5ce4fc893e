"""Mean host us of one Gauss-Newton loop trip, the program's `kiss/gn_trip`
span (ops/control.py): from the read that let the trip run to the next
test's read, the host issuing the trip's work (`engine.gn_unroll`
iterations: K2, K1, the 6x6 solve, the update) and the next test. What a
graph over one trip could save. Per trip, so it does not depend on which
frames the trace caught. Moves frames_per_s."""

SPAN = "kiss/gn_trip"


def read(ctx):
    trips = [e - s for n, s, e in ctx.trace.spans if n == SPAN]
    return sum(trips) / len(trips) if trips else None
