"""Gauss-Newton iterations a frame, over every frame the window returned
(the program's own `num_iterations`)."""


def read(ctx):
    if not ctx.iterations:
        return None
    return sum(ctx.iterations) / len(ctx.iterations)
