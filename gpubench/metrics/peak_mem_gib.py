"""The allocator's peak over the window (torch.cuda.max_memory_allocated
after a reset at the window's start), GiB: the pass size that fits."""


def read(ctx):
    if not ctx.window_peak_bytes:
        return None
    return ctx.window_peak_bytes / float(1 << 30)
