from . import colmap, ply  # noqa: F401
