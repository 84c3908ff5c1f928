"""PNG and JPEG read and write on Pillow.

The port's one image codec: `imread` and `imwrite` decode and encode as
`imageio.v2.imread` / `imwrite` do through their Pillow plugin (which is
what imageio uses for PNG and JPEG), so files and arrays are the same:

- 8-bit grey (H, W) uint8 and RGB (H, W, 3) uint8 PNG and JPEG;
- 16-bit grey (H, W) uint16 PNG (`.sens` depth exports, ScanNet's
  `label-filt`): Pillow opens it as mode "I" and the array comes back as
  "I;16", uint16, as imageio returns it;
- palette PNGs decode to their palette's mode (RGB or RGBA).

Writes pass no save options, as imageio passes none: Pillow's defaults
(PNG zlib level 6, no optimize; JPEG quality 75, 4:2:0 subsampling), so
a file written here is byte-identical to imageio's. `format` names the
codec ("png", "jpeg") where the target is a buffer; for a path the
extension decides.
"""

from __future__ import annotations

import io
import os

import numpy as np
from PIL import Image


def _open(uri):
    if isinstance(uri, (bytes, bytearray, memoryview)):
        return Image.open(io.BytesIO(bytes(uri)))
    return Image.open(uri)


def imread(uri):
    """The first frame of a path, file object or encoded bytes as a numpy
    array: (H, W) for grey, (H, W, 3|4) for colour, uint8 or uint16."""
    with _open(uri) as image:
        image.seek(0)
        if image.mode == "P":
            image = image.convert(image.palette.mode)
        elif image.format == "PNG" and image.mode == "I":
            image = image.convert("I;16")
        return np.array(image)


def _format(uri, format):
    if format is not None:
        ext = "." + format.lower().lstrip(".")
    elif isinstance(uri, (str, os.PathLike)):
        ext = os.path.splitext(os.fspath(uri))[1].lower()
    else:
        raise ValueError("imwrite to a buffer needs format=")
    formats = Image.registered_extensions()
    if ext not in formats:
        Image.init()
        formats = Image.registered_extensions()
    if ext not in formats:
        raise ValueError(f"Pillow cannot write {ext!r} files")
    return formats[ext]


def imwrite(uri, array, format=None):
    """Write a 2D (grey) or (H, W, 3|4) array to a path or a file object.
    uint16 grey writes a 16-bit PNG."""
    array = np.asarray(array)
    if not np.issubdtype(array.dtype, np.number):
        raise ValueError(f"image is not numeric: {array.dtype}")
    if array.ndim == 3 and array.shape[-1] == 1:
        raise ValueError("cannot write images with one colour channel")
    if array.ndim not in (2, 3):
        raise ValueError(f"image must be 2D or (H, W, 3|4), got "
                         f"{array.shape}")
    Image.fromarray(array).save(uri, format=_format(uri, format))
