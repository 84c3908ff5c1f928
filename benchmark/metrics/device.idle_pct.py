"""100 x (1 - the union of the device's kernel, memcpy and memset
intervals / the wall time of the traced batches)."""


def read(ctx):
    idle = ctx.trace.idle_share() if ctx.trace is not None else None
    return None if idle is None else 100.0 * idle
