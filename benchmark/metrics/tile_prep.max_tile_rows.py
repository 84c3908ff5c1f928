"""The program's counter `tiles.max_tile_rows`: the longest (32, 128)
tile list, in candidates, that the set-up probe found in one view
(`TrianglesRenderer.prepare` on the tile route); the list length kernel
A is handed is sized from it. Nothing where the program has no such
counter or the probe never ran."""


def read(ctx):
    from semantic_meshes_torch import profiling

    counters = getattr(profiling, "counters", None)
    value = counters().get("tiles.max_tile_rows") if counters else None
    return None if value is None else float(value)
