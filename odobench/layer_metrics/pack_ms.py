"""Host ms a frame registered in the program's `kiss/pack` span: the host
wrapper allocating its input buffer and padding the scans into it
(`KissICP.build_chunk`, `BatchedOdometry.register_frames`). Moves frames_per_s."""

SPANS = ('kiss/pack',)


def read(ctx):
    us = ctx.trace.span_us(*SPANS)
    return us / 1e3 / len(ctx.traced) if us and ctx.traced else None
