"""Carry state across from the JAX package `semantic_meshes`.

The JAX package's objects hold numpy (or jax) arrays that `np.asarray`
exports; these helpers read them by attribute and build this package's
objects from the exported arrays, so both sides compute from the same
state. Nothing here imports the JAX package: any object with the same
attributes converts.
"""

from __future__ import annotations

import numpy as np

from . import fusion
from .data import Camera, Ply


def camera(cam) -> Camera:
    """A `semantic_meshes.data.Camera` (or look-alike) as a port Camera."""
    return Camera(
        np.asarray(cam.rotation, np.float32),
        np.asarray(cam.translation, np.float32),
        tuple(int(r) for r in cam.resolution),
        np.asarray(cam.focal_lengths, np.float32),
        np.asarray(cam.principal_point, np.float32),
        distortion=None if getattr(cam, "distortion", None) is None
        else np.asarray(cam.distortion, np.float32),
    )


def ply(mesh) -> Ply:
    """A `semantic_meshes.data.Ply` (or look-alike) as a port Ply with the
    same vertices, faces and path."""
    out = object.__new__(Ply)
    out.path = str(getattr(mesh, "path", ""))
    out.vertices = np.asarray(mesh.vertices, np.float32)
    out.faces = np.asarray(mesh.faces, np.int32)
    return out


def texel_params(renderer):
    """A `semantic_meshes.render.TexelsRenderer`'s (or look-alike's) texel
    tables as numpy arrays: (reordered faces (T, 3) int32, resolutions (T,)
    int32, first_texel_index (T,) int32, getPrimitivesNum()), the inputs
    of render._texel_prim_image and distributed.fuse_views_texels."""
    return (np.asarray(renderer.faces, np.int32),
            np.asarray(renderer.resolutions, np.int32),
            np.asarray(renderer.first_texel_index, np.int32),
            int(renderer.getPrimitivesNum()))


def mesh_aggregator(agg, device="cuda") -> fusion.MeshAggregator:
    """A `semantic_meshes.fusion.MeshAggregator` as a port MeshAggregator:
    same primitives, classes, aggregator name, images_equal_weight and
    accumulator state."""
    out = fusion.MeshAggregator(
        agg.primitives, agg.classes, aggregator=agg.aggregator,
        images_equal_weight=agg.images_equal_weight, device=device,
    )
    out.state = np.asarray(agg.state, np.float32)
    return out


def segmentation_params(tree, arch, widths):
    """The JAX package's segmentation parameter tree (`{"params": {...}}`
    of `UNet` / `PSPNet` / `RGBDUNet`.init, numpy, jax or tensor leaves)
    as a state_dict of the port's `models.segmentation.ARCHS[arch]` at
    `widths`: a flax path `a/b/kernel` becomes `a.b.weight` with the
    (kh, kw, in, out) kernel permuted to (out, in, kh, kw), GroupNorm's
    `scale` becomes `weight`, `bias` stays. A key missing from the tree
    or not in the model raises KeyError; shapes are checked by
    `load_state_dict`."""
    from collections.abc import Mapping

    import torch

    from .models import segmentation

    def tensor(v):
        return v if torch.is_tensor(v) else torch.from_numpy(
            np.array(v, np.float32))

    state = {}

    def walk(node, path):
        for name, value in node.items():
            if isinstance(value, Mapping):
                walk(value, path + (name,))
            elif name == "kernel":
                state[".".join(path + ("weight",))] = tensor(
                    value).permute(3, 2, 0, 1).contiguous()
            else:
                key = {"scale": "weight", "bias": "bias"}.get(name)
                if key is None:
                    raise KeyError(f"unknown flax leaf {'/'.join(path)}/"
                                   f"{name}")
                state[".".join(path + (key,))] = tensor(value)

    walk(dict(tree["params"]), ())
    with torch.device("meta"):
        want = set(segmentation.ARCHS[arch](
            classes=1, widths=tuple(widths)).state_dict())
    missing, extra = sorted(want - set(state)), sorted(set(state) - want)
    if missing or extra:
        raise KeyError(f"{arch} {tuple(widths)}: missing {missing}, "
                       f"not in the model {extra}")
    return state
