"""The tile preparation's device time in the traced batches over their
views, in ms: the summed device time of csrc/tile_prep.cu's kernels
(tile_setup_kernel, tile_bins_kernel). None where neither ran: a program
that prepares the tile route with another implementation, or a cell on
the dense route."""

KERNELS = ("tile_setup_kernel", "tile_bins_kernel")


def read(ctx):
    if ctx.trace is None or ctx.traced_views == 0:
        return None
    total_us, n = 0.0, 0
    for name in KERNELS:
        us, count = ctx.trace.kernel(name)
        total_us, n = total_us + us, n + count
    if n == 0:
        return None
    return total_us / 1e3 / ctx.traced_views
