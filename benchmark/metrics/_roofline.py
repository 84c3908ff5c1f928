"""The yardstick of the kernels' roofline shares: the card's peak and
the least bytes a z-resolve kernel has to move."""

# NVIDIA H100 SXM5 80 GB data sheet: HBM3 bandwidth, at the full 700 W
HBM_BYTES_PER_S = 3.35e12


def z_resolve_bytes(width, height, vertices, faces):
    """Bytes a z-resolve of one view needs at least: an int32 id and a
    float32 depth written per pixel, and the real mesh read once (three
    float32 coordinates a vertex, three int32 indices a face). Padding
    rows are not counted."""
    return width * height * 8 + vertices * 12 + faces * 12


def share_pct(ctx, kernel):
    """100 x least time / measured time of `kernel` a launch, or None
    where the trace holds no launch of it."""
    total_us, n = ctx.trace.kernel(kernel)
    if n == 0 or total_us <= 0:
        return None
    least_s = z_resolve_bytes(ctx.width, ctx.height, ctx.vertices,
                              ctx.faces) / HBM_BYTES_PER_S
    return 100.0 * least_s / (total_us / n / 1e6)
