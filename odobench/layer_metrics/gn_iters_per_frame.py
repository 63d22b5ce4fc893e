"""Gauss-Newton iterations a frame (the program's own `num_iterations`)
over the frames of the traced calls: the frames the span readers see, so
that two commits compare the same frames. Moves frames_per_s."""


def read(ctx):
    iters = [ctx.iterations[i] for i in ctx.traced if i < len(ctx.iterations)]
    return sum(iters) / len(iters) if iters else None
