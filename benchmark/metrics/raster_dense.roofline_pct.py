"""Kernel B's (csrc/raster_dense.cu, raster_dense_kernel) share of its
roofline: the least time of a view's bytes (_roofline.z_resolve_bytes) at
the HBM peak over its measured device time a launch."""

from benchmark.metrics import _roofline


def read(ctx):
    if ctx.trace is None:
        return None
    return _roofline.share_pct(ctx, "raster_dense_kernel")
