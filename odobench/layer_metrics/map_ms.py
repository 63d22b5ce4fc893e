"""Host ms a frame registered in `kiss/map_insert` + `kiss/map_trim`:
map insert and trim (ops/hash_map.py). Moves frames_per_s."""

SPANS = ('kiss/map_insert', 'kiss/map_trim')


def read(ctx):
    us = ctx.trace.span_us(*SPANS)
    return us / 1e3 / len(ctx.traced) if us and ctx.traced else None
