"""CUDA kernels in the device trace a frame registered: the host's
op-by-op issue. Moves frames_per_s."""


def read(ctx):
    kernels = ctx.trace.kernels()
    if not kernels or not ctx.traced:
        return None
    return len(kernels) / len(ctx.traced)
