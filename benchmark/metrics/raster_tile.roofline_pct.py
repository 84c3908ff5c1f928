"""Kernel A's (csrc/raster_tile.cu, raster_tile_kernel) share of its
roofline: the least time of a view's bytes (_roofline.z_resolve_bytes,
the count kernel B is held to) at the HBM peak over its measured device
time a launch."""

from benchmark.metrics import _roofline


def read(ctx):
    if ctx.trace is None:
        return None
    return _roofline.share_pct(ctx, "raster_tile_kernel")
