"""The bundled segmentation predictors (counterpart of the JAX package's
`semantic_meshes/models/`): `segmentation` holds UNet, PSPNet, RGBDUNet,
the `sliding` / `multi_scale` combinators and the loaders;
`serialization` reads flax's msgpack parameter files."""

from . import segmentation  # noqa: F401
from . import serialization  # noqa: F401
