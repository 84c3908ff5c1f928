"""Process start to the first timed batch (host clock): imports, scene,
plan, texel sizing, probability pool, warm-up (and, in the first run of
a checkout, the nvcc builds)."""


def read(ctx):
    return ctx.setup_s
