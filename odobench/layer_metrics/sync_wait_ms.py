"""Host ms a frame registered inside the program's `kiss/sync/<site>`
spans (kiss_icp_tpu_torch/trace.py): the host blocked in a read of a
device value, waiting for the card. Moves frames_per_s."""

PREFIX = "kiss/sync/"


def read(ctx):
    us = sum(e - s for _, s, e in ctx.trace.spans_with_prefix(PREFIX))
    return us / 1e3 / len(ctx.traced) if us and ctx.traced else None
