"""Host seconds of the program's set-up span `smt.setup.budgets`: the
dense budgets' probes over every frame (`TrianglesRenderer.prepare`), or
the demo's plan (`distributed.plan_fuse`), up to the probes' read to the
host. The program's own timer; nothing where the program has none."""

from benchmark import spans


def read(ctx):
    return spans.setup_s("smt.setup.budgets")
