"""The traversal kernels' share of their roofline in a render frame, %
(profile.walk_roofline_pct); nothing where no walk ran."""
from gpubench import profile


def read(ctx):
    if ctx.entry != "render":
        return None
    return profile.walk_roofline_pct(ctx.trace, ctx.traffic, ctx.n_prims)
