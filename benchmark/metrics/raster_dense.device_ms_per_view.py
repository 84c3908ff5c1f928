"""Kernel B's (csrc/raster_dense.cu, raster_dense_kernel) device time in
the traced batches over their views, in ms: the z-resolve's cost a
frame, which the global bucket's rows raise."""


def read(ctx):
    if ctx.trace is None or ctx.traced_views == 0:
        return None
    total_us, n = ctx.trace.kernel("raster_dense_kernel")
    if n == 0:
        return None
    return total_us / 1e3 / ctx.traced_views
