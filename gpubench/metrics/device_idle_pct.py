"""The share of the traced frames' wall time in which no device operation
ran, %."""
from gpubench import profile


def read(ctx):
    return 100.0 * (1.0 - profile.busy_s(ctx.trace) / ctx.trace.window_s)
