"""Host ms a frame registered in the program's `kiss/h2d` span: the host
wrapper moving the padded scans to the card (`KissICP._to_device`, the
batch's `_on`). Moves frames_per_s."""

SPANS = ('kiss/h2d',)


def read(ctx):
    us = ctx.trace.span_us(*SPANS)
    return us / 1e3 / len(ctx.traced) if us and ctx.traced else None
