"""Host reads of a device value a frame registered: the program's
`kiss/sync/<site>` spans (kiss_icp_tpu_torch/trace.py: each GN loop test,
each claim round's test, the map's row lists, the pose reads) over the
traced frames. Moves frames_per_s."""

PREFIX = "kiss/sync/"


def read(ctx):
    n = len(ctx.trace.spans_with_prefix(PREFIX))
    return n / len(ctx.traced) if n and ctx.traced else None
