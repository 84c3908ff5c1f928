"""Views x width x height of every batch completed in the window, in
millions, over the window's wall time (host clock)."""


def read(ctx):
    w = ctx.window
    if w is None or w["completed"] == 0 or w["wall_s"] <= 0:
        return None
    return w["completed"] * w["pixels_per_batch"] / 1e6 / w["wall_s"]
