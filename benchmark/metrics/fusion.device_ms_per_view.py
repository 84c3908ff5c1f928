"""Fusion's device time in the traced batches over their views, in ms:
the summed device time of csrc/fusion.cu's kernels (fusion_keys_kernel,
fusion_rows_kernel, fusion_carry_kernel; the keys' sort between them is
PyTorch's and not counted). None where none of them ran: a program that
fuses with another implementation."""

KERNELS = ("fusion_keys_kernel", "fusion_rows_kernel", "fusion_carry_kernel")


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
