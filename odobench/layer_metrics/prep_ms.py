"""Host ms a frame registered in `kiss/preprocess` + `kiss/downsample`:
deskew, crop and both voxel downsamples (ops/preprocess.py, ops/voxel.py). Moves frames_per_s."""

SPANS = ('kiss/preprocess', 'kiss/downsample')


def read(ctx):
    us = ctx.trace.span_us(*SPANS)
    return us / 1e3 / len(ctx.traced) if us and ctx.traced else None
