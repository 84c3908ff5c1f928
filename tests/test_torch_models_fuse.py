"""The port's segmentation predictors inside its batched pipeline
(distributed.fuse_views / fuse_views_texels with predict_fn), against the
same fusions of precomputed predictions, the per-view path and the JAX
package's fusions over the same probabilities, on the CPU.

Predictions come from the port alone (flax init statistics, seed 0), so
the fusions compare exactly where the port meets itself and at rtol 2e-5,
atol 1e-5 against JAX (test_end_to_end.py's bound: another summation
order). Shapes: the cube s=3 (108 triangles), 3 ring views of 64x48.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import semantic_meshes
from semantic_meshes import distributed as jdist
from semantic_meshes_torch import data, distributed, fusion, render, testing
from semantic_meshes_torch.io.ply import write_mesh
from semantic_meshes_torch.models import segmentation

CPU = "cpu"
W, H, VIEWS, CLASSES = 64, 48, 3, 4
RTOL, ATOL = 2e-5, 1e-5


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("models_fuse")
    vertices, faces = testing.make_cube(subdivisions=3)
    write_mesh(tmp / "cube.ply", vertices, faces)
    cams = testing.make_ring_cameras(num_views=VIEWS, width=W, height=H)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (VIEWS, H, W, 3)).astype(np.uint8)
    return SimpleNamespace(vertices=vertices, faces=faces, cams=cams,
                           images=images, path=str(tmp / "cube.ply"),
                           arrays=data.stack_cameras(cams))


def _fuse(s, probs, **kw):
    return distributed.fuse_views(
        s.vertices, s.faces, *s.arrays, probs, 0.5, num_primitives=len(
            s.faces), aggregator="sum", height=H, width=W, device=CPU, **kw)


def _jax_fuse(s, probs):
    return jdist.fuse_views(
        s.vertices, s.faces, *s.arrays, np.asarray(probs), np.float32(0.5),
        num_primitives=len(s.faces), aggregator="sum", height=H, width=W)


def _per_view(s, predict, inputs, P, renderer):
    agg = fusion.MeshAggregator(P, CLASSES, "sum", 0.5, device=CPU)
    for k, cam in enumerate(s.cams):
        probs = predict(*(leaf[k] for leaf in inputs))
        agg.add(renderer.render(cam)[0], probs.transpose(0, 1))
    return agg.state


def _bench_predict_fn():
    """bench.py's e2e hook: softmax(model(img / 255)) of one raw uint8
    view at its own size (no resize)."""
    model = segmentation.load_predictor(
        classes=CLASSES, input_hw=(H, W), widths=(8, 16), device=CPU).model

    @torch.inference_mode()
    def predict_fn(img):
        x = torch.as_tensor(img).to(torch.float32) / 255.0
        return torch.softmax(model(x[None])[0], dim=-1)

    return predict_fn


def test_predictor_as_predict_fn_equals_precomputed_and_jax(scene):
    predict = segmentation.load_predictor(
        classes=CLASSES, input_hw=(32, 32), widths=(8, 16), device=CPU)
    acc, overflow = _fuse(scene, scene.images, predict_fn=predict)
    probs = torch.stack([predict(img) for img in scene.images])
    pre, pre_overflow = _fuse(scene, probs)
    assert int(overflow) == int(pre_overflow) == 0
    assert torch.equal(acc, pre)
    assert tuple(acc.shape) == (len(scene.faces), CLASSES)
    jacc, jov = _jax_fuse(scene, probs.numpy())
    assert int(jov) == 0
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), rtol=RTOL,
                               atol=ATOL)
    per_view = _per_view(scene, predict, (scene.images,), len(scene.faces),
                         render.triangles(data.Ply(scene.path), device=CPU))
    np.testing.assert_allclose(acc.numpy(), per_view.numpy(), rtol=1e-6,
                               atol=0)


def test_bench_style_predict_fn_on_raw_images(scene):
    """bench.py's e2e hook over raw uint8 views, one view at a time."""
    predict_fn = _bench_predict_fn()
    acc, overflow = _fuse(scene, torch.from_numpy(scene.images),
                          predict_fn=predict_fn)
    probs = torch.stack([predict_fn(img) for img in scene.images])
    assert int(overflow) == 0
    assert torch.equal(acc, _fuse(scene, probs)[0])
    np.testing.assert_allclose(acc.numpy(), np.asarray(
        _jax_fuse(scene, probs)[0]), rtol=RTOL, atol=ATOL)


def test_rgbd_tuple_inputs_equal_per_view(scene):
    """probs=(colors, depths), predict_fn=lambda pr: predict(*pr): view i
    gets (colors[i], depths[i]), as the JAX scan slices a pytree; equal to
    the per-view predict -> render -> MeshAggregator.add path."""
    predict = segmentation.load_rgbd_predictor(
        classes=CLASSES, input_hw=(32, 32), widths=(8, 16), device=CPU)
    rng = np.random.default_rng(1)
    depths = rng.integers(0, 5000, (VIEWS, H // 2, W // 2)).astype(np.uint16)
    inputs = (scene.images, depths)
    acc, overflow = _fuse(scene, inputs, predict_fn=lambda pr: predict(*pr))
    assert int(overflow) == 0
    per_view = _per_view(scene, predict, inputs, len(scene.faces),
                         render.triangles(data.Ply(scene.path), device=CPU))
    np.testing.assert_allclose(acc.numpy(), per_view.numpy(), rtol=1e-6,
                               atol=0)
    probs = np.stack([predict(c, d).numpy() for c, d in zip(*inputs)])
    np.testing.assert_allclose(acc.numpy(), np.asarray(
        _jax_fuse(scene, probs)[0]), rtol=RTOL, atol=ATOL)


def test_texel_run_shaped_like_bench_e2e(scene):
    """bench.py's e2e in small: texels at 0.1 per pixel, a UNet's softmax
    as predict_fn over raw uint8 views inside fuse_views_texels, sum
    fusion; equal to the same fusion of the stacked predictions and to
    the JAX package's fuse_views_texels over them."""
    renderer = render.texels(data.Ply(scene.path), scene.cams, 0.1,
                             device=CPU)
    jrenderer = semantic_meshes.render.texels(
        semantic_meshes.data.Ply(scene.path), scene.cams, 0.1)
    P = renderer.getPrimitivesNum()
    assert P == jrenderer.getPrimitivesNum()
    predict_fn = _bench_predict_fn()
    def fuse(probs, **kw):
        return distributed.fuse_views_texels(
            scene.vertices, renderer.faces, renderer.resolutions,
            renderer.first_texel_index, *scene.arrays, probs, 0.5,
            num_primitives=P, aggregator="sum", height=H, width=W,
            device=CPU, **kw)

    acc, overflow = fuse(scene.images, predict_fn=predict_fn)
    probs = torch.stack([predict_fn(img) for img in scene.images])
    assert int(overflow) == 0
    assert torch.equal(acc, fuse(probs)[0])
    seen = acc.abs().sum(-1) > 0
    assert 0.3 < float(seen.float().mean()) < 1.0
    jacc, jov = jdist.fuse_views_texels(
        jrenderer.vertices, jrenderer.faces, jrenderer.resolutions,
        jrenderer.first_texel_index, *scene.arrays, probs.numpy(),
        np.float32(0.5), num_primitives=P, aggregator="sum", height=H,
        width=W)
    assert int(jov) == 0
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), rtol=RTOL,
                               atol=ATOL)
