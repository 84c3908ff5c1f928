"""Carry state across from the JAX package `semantic_meshes`.

The JAX package's objects hold numpy (or jax) arrays that `np.asarray`
exports; these helpers read them by attribute and build this package's
objects from the exported arrays, so both sides compute from the same
state. Nothing here imports the JAX package: any object with the same
attributes converts. `flax_params` goes the other way, from a port
state_dict to the JAX package's parameter tree (the tree a flax msgpack
file holds).
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
    want = set(_model_keys(arch, widths))
    missing, extra = sorted(want - set(state)), sorted(set(state) - want)
    if missing or extra:
        raise KeyError(f"{arch} {tuple(widths)}: missing {missing}, "
                       f"not in the model {extra}")
    return state


def _model_keys(arch, widths):
    """The state_dict keys of `models.segmentation.ARCHS[arch]` at
    `widths`, in the model's parameter order."""
    import torch

    from .models import segmentation

    with torch.device("meta"):
        model = segmentation.ARCHS[arch](classes=1, widths=tuple(widths))
    return [name for name, _ in model.named_parameters()]


def flax_params(state_dict, arch, widths):
    """The inverse of segmentation_params: a state_dict of the port's
    `ARCHS[arch]` at `widths` as the JAX package's parameter tree
    `{"params": {...}}` with float32 numpy leaves: `a.b.weight` of a
    convolution becomes `a/b/kernel`, permuted back to (kh, kw, in, out),
    GroupNorm's `weight` becomes `scale`, `bias` stays. The keys must be
    the model's (KeyError otherwise)."""
    import torch

    want = _model_keys(arch, widths)
    missing = sorted(set(want) - set(state_dict))
    extra = sorted(set(state_dict) - set(want))
    if missing or extra:
        raise KeyError(f"{arch} {tuple(widths)}: missing {missing}, "
                       f"not in the model {extra}")
    tree = {}
    for key in want:
        value = state_dict[key].detach().cpu().to(torch.float32)
        *path, leaf = key.split(".")
        node = tree
        for name in path:
            node = node.setdefault(name, {})
        if value.ndim == 4:
            node["kernel"] = value.permute(2, 3, 1, 0).contiguous().numpy()
        elif leaf == "weight":
            node["scale"] = value.numpy().copy()
        else:
            node["bias"] = value.numpy().copy()
    return {"params": tree}


def adamw_state(opt_state, arch, widths):
    """optax's adamw state (a tuple holding `ScaleByAdamState(count, mu,
    nu)`, read by attribute) as the port's `torch.optim.AdamW` state, per
    state_dict key of `ARCHS[arch]` at `widths`: {key: {"step": float32
    scalar tensor, "exp_avg": mu, "exp_avg_sq": nu}}, with
    segmentation_params' leaf mapping (kernels permuted to (out, in, kh,
    kw)). Keyed by parameter index in `model.named_parameters()` order,
    it is the "state" of an `AdamW.state_dict()` over that model."""
    import torch

    adam = [s for s in opt_state if hasattr(s, "mu") and hasattr(s, "nu")]
    if len(adam) != 1:
        raise ValueError("opt_state holds no single ScaleByAdamState")
    count, mu, nu = adam[0].count, adam[0].mu, adam[0].nu
    step = torch.tensor(float(np.asarray(count)), dtype=torch.float32)
    mu = segmentation_params(mu, arch, widths)
    nu = segmentation_params(nu, arch, widths)
    return {k: {"step": step.clone(), "exp_avg": mu[k], "exp_avg_sq": nu[k]}
            for k in mu}
