"""Share of the map updates that replay a CUDA graph, in percent: the
program's `kiss/map_replay` spans over its `kiss/map_insert` spans
(kiss_icp_tpu_torch/ops/hash_map.py `update`, ops/control.py) in the
traced calls. An update that replays nothing captured its graph
(`kiss/map_capture`: the first update of a set of map tables) or ran the
live insert and trim. A program without the replay span gives no reading.
Moves frames_per_s."""

UPDATE, REPLAY = "kiss/map_insert", "kiss/map_replay"


def read(ctx):
    updates = sum(1 for n, _, _ in ctx.trace.spans if n == UPDATE)
    replays = sum(1 for n, _, _ in ctx.trace.spans if n == REPLAY)
    return 100.0 * replays / updates if updates and replays else None
