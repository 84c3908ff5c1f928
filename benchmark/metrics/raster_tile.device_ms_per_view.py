"""Kernel A's (csrc/raster_tile.cu, raster_tile_kernel) device time in
the traced batches over their views, in ms: the tile route's z-resolve
a frame, which its longest tile lists raise."""


def read(ctx):
    if ctx.trace is None or ctx.traced_views == 0:
        return None
    total_us, n = ctx.trace.kernel("raster_tile_kernel")
    if n == 0:
        return None
    return total_us / 1e3 / ctx.traced_views
