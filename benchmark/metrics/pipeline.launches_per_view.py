"""The host's CUDA runtime and driver calls that put work on the device
(kernel, memcpy, memset and graph launches) in the traced batches, over
their views. A count: it repeats exactly on the same code."""


def read(ctx):
    t = ctx.trace
    if t is None or t.launches == 0 or ctx.traced_views == 0:
        return None
    return t.launches / ctx.traced_views
