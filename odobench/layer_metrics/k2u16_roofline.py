"""K2's share of its roofline on a u16 map, in %: `roofline.py`'s K2 share
(the 27-voxel nearest-neighbour query, kernels/nn27.py + csrc/nn27.cu) with
each stored point read as its three 16-bit offsets, 6 bytes, in place of
the 12 of an f32 point (`work.BYTES_PER_POINT`). The counts come from the
reference's replay of each traced frame (`reference/kiss_soak.py`). Moves
frames_per_s."""

from odobench import work

NEEDS_WORK = True
# A u16 map stores a point as 3 x uint16.
BYTES_PER_POINT = 6
KERNEL = "nn27_kernel"
# K2 counts the final correspondences once more than the GN iterations.
EXTRA_LAUNCHES = 1


def least_seconds(record: dict) -> float:
    """The least time the card needs for one K2 query of a work record."""
    nbytes = (record["queries"] * work.K2_BYTES_PER_QUERY
              + record["voxels"] * work.K2_BYTES_PER_VOXEL
              + record["voxel_points"] * BYTES_PER_POINT)
    return work.bound(nbytes, {"f32": work.K2_FLOPS_PER_CANDIDATE * record["candidates"]})[0]


def read(ctx):
    kernels = [d for d in ctx.trace.kernels() if KERNEL in d[0]]
    device_s = sum(d for _, _, d in kernels) / 1e6
    least, launches = 0.0, 0
    for pos in ctx.traced:
        records = ctx.work.get(pos)
        if not records:
            continue
        n = ctx.iterations[pos] + EXTRA_LAUNCHES
        least += sum(least_seconds(r) for r in records) / len(records) * n
        launches += n
    if not kernels or not launches or device_s <= 0:
        return None
    # Scale to the launches the trace holds.
    return 100.0 * least * (len(kernels) / launches) / device_s
