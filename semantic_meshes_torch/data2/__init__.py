from .scannet import RGBDFrame, SensFile  # noqa: F401
