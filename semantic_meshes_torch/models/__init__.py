"""The bundled segmentation predictors (counterpart of the JAX package's
`semantic_meshes/models/`): `segmentation` holds UNet, PSPNet, RGBDUNet,
the `sliding` / `multi_scale` combinators and the loaders;
`serialization` reads and writes flax's msgpack parameter files;
`training` holds the SegmentationTrainer and its data-parallel step."""

from . import segmentation  # noqa: F401
from . import serialization  # noqa: F401
from . import training  # noqa: F401
