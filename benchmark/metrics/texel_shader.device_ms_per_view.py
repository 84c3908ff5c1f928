"""The texel shader's device time in the traced batches over their views,
in ms: the summed device time of csrc/texel_shader.cu's kernels
(texel_table_kernel, texel_shade_kernel). None where neither ran: a
program that shades texels with another implementation."""

KERNELS = ("texel_table_kernel", "texel_shade_kernel")


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
