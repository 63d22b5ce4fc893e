"""Host ms a frame in the port's wrappers outside its `kiss/*` stages: the
benchmark's `odobench/*` spans around each call, less the time that
`kiss/` spans cover inside them. The spans nest (`kiss/frame` around the
stages, the trips and reads inside `kiss/align`), so only the outermost
count: each instant of a call is subtracted once. Moves frames_per_s."""


def read(ctx):
    calls = ctx.trace.calls()
    if not calls or not ctx.traced:
        return None
    stages = ctx.trace.spans_with_prefix("kiss/")  # by start
    outside = 0.0
    for _, start, end in calls:
        covered, reached = 0.0, start
        for _, s, e in stages:
            s, e = max(s, reached), min(e, end)
            if e > s:
                covered += e - s
                reached = e
        outside += end - start - covered
    return outside / 1e3 / len(ctx.traced)
