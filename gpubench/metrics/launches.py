"""Device kernels launched a frame (memory copies and sets left out),
from the trace: the host's launch rate is what holds the device idle at
small wavefronts."""


def read(ctx):
    return len(ctx.trace.kernels) / ctx.trace.frames
