"""Share of its roofline that a kernel reaches over the traced frames, in
%, for `<kernel>_roofline.<variant>` (k1: the normal equations,
kernels/linsys.py + csrc/linsys.cu; k2: the 27-voxel nearest-neighbour
query, kernels/nn27.py + csrc/nn27.cu): the least time the card needs for
the work the frames' inputs need (odobench/work.py, counted on the
reference's replay of each traced frame, per GN iteration, times the
program's launches of that frame) over the kernel's device time in the
trace. Moves frames_per_s."""

from odobench import work

NEEDS_WORK = True
# kernel -> (name in the trace, launches a frame beyond its GN iterations,
# index into work.least_seconds). K2 counts the final correspondences once
# more.
KERNELS = {"k1": ("linsys_kernel", 0, 1), "k2": ("nn27_kernel", 1, 0)}


def read(ctx):
    name, extra, which = KERNELS[ctx.metric.split("_roofline", 1)[0]]
    kernels = [d for d in ctx.trace.kernels() if name in d[0]]
    device_s = sum(d for _, _, d in kernels) / 1e6
    least, launches = 0.0, 0
    for pos in ctx.traced:
        records = ctx.work.get(pos)
        if not records:
            continue
        per_launch = sum(work.least_seconds(r)[which] for r in records) / len(records)
        n = ctx.iterations[pos] + extra
        least += per_launch * n
        launches += n
    if not kernels or not launches or device_s <= 0:
        return None
    # Scale to the launches the trace holds (equal unless the loop's shape
    # changed).
    return 100.0 * least * (len(kernels) / launches) / device_s
