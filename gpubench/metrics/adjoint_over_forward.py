"""A gradient step's time over a forward render's, at the same scene and
config: the mean of two steps over the mean of two renders, taken in
turns after the traced window (entries/grad_step.py's trace_extras)."""


def read(ctx):
    return ctx.extra.get("adjoint_over_forward")
