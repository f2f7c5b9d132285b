"""Device milliseconds a frame of the traversal kernels (the kernels whose
name holds closest_hit or any_hit: kernels/traverse.py's CUDA walks);
nothing where no walk ran (brute force)."""
from gpubench import profile


def read(ctx):
    s = profile.device_seconds(ctx.trace, profile.WALK)
    return s * 1e3 / ctx.trace.frames if s > 0 else None
