"""The program's counter `dense.global_rows`: the largest global bucket,
in big rows (triangles that span more than 2x2 dense tiles), that the
set-up probe found in one view (`TrianglesRenderer.prepare`,
`distributed.plan_fuse`); the cap kernel B tests is sized from it.
Nothing where the program has no such counter or the probe never ran."""


def read(ctx):
    from semantic_meshes_torch import profiling

    counters = getattr(profiling, "counters", None)
    value = counters().get("dense.global_rows") if counters else None
    return None if value is None else float(value)
