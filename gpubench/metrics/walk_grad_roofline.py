"""The traversal kernels' share of their roofline in a grad frame, %
(profile.walk_roofline_pct); nothing where no walk ran."""
from gpubench import profile


def read(ctx):
    if ctx.entry != "grad_step":
        return None
    return profile.walk_roofline_pct(ctx.trace, ctx.traffic, ctx.n_prims)
