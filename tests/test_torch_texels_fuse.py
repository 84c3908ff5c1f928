"""Batched texel-mode fusion of semantic_meshes_torch
(distributed.fuse_views_texels) against the port's per-view path
(TexelsRenderer.render -> MeshAggregator.add) and against the JAX
package's fuse_views_texels, on the CPU, with the tile rasterizer (cube
s=3) and the dense one (cube s=37, JAX op by op). Mirrors
tests/test_distributed_texels.py."""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import semantic_meshes
from semantic_meshes import distributed as jdist
from semantic_meshes import testing as jtesting
from semantic_meshes.data import stack_cameras
from semantic_meshes_torch import data, distributed, fusion, render, testing
from semantic_meshes_torch.io.ply import write_mesh

RTOL, ATOL = 1e-5, 1e-6  # another summation order than the JAX package's


def _scene(tmp_path_factory, subdivisions, views, tpp, radius=3.0):
    tmp = tmp_path_factory.mktemp(f"texels{subdivisions}")
    vertices, faces = testing.make_cube(subdivisions=subdivisions)
    write_mesh(tmp / "cube.ply", vertices, faces)
    cams = testing.make_ring_cameras(num_views=views, width=128, height=96,
                                     radius=radius)
    renderer = render.texels(data.Ply(str(tmp / "cube.ply")), cams, tpp,
                             device="cpu")
    jrenderer = semantic_meshes.render.texels(
        semantic_meshes.data.Ply(str(tmp / "cube.ply")), cams, tpp)
    return vertices, cams, renderer, jrenderer


@pytest.fixture(scope="module")
def tile_scene(tmp_path_factory):
    return _scene(tmp_path_factory, 3, 3, 1.5)


@pytest.fixture(scope="module")
def dense_scene(tmp_path_factory):
    # close enough that some triangles span more than the micro threshold,
    # so the plan has pairs and the dense kernel's plain version runs
    return _scene(tmp_path_factory, 37, 2, 0.5, radius=1.5)


def _probs(views, classes, seed):
    rng = np.random.default_rng(seed)
    return np.stack([jtesting.random_probs(rng, 96, 128, classes, 0.1)
                     for _ in range(views)])


def _per_view(renderer, cams, probs, aggregator, weights=None):
    agg = fusion.MeshAggregator(renderer.getPrimitivesNum(), probs.shape[-1],
                                aggregator, 0.5, device="cpu")
    for k, cam in enumerate(cams):
        agg.add(renderer.render(cam)[0], probs[k].transpose(1, 0, 2),
                None if weights is None else weights[k].T)
    return agg.state


def _fuse(renderer, vertices, cams, probs, aggregator, **kw):
    return distributed.fuse_views_texels(
        vertices, renderer.faces, renderer.resolutions,
        renderer.first_texel_index, *stack_cameras(cams), probs, 0.5,
        num_primitives=renderer.getPrimitivesNum(), aggregator=aggregator,
        height=96, width=128, device="cpu", **kw)


def _jax_fuse(jrenderer, cams, probs, aggregator, **kw):
    return jdist.fuse_views_texels(
        jrenderer.vertices, jrenderer.faces, jrenderer.resolutions,
        jrenderer.first_texel_index, *stack_cameras(cams), probs,
        np.float32(0.5), num_primitives=jrenderer.getPrimitivesNum(),
        aggregator=aggregator, height=96, width=128, **kw)


@pytest.mark.parametrize("aggregator", ["sum", "summax", "mul"])
def test_fuse_views_texels_matches_per_view_and_jax(tile_scene, aggregator):
    vertices, cams, renderer, jrenderer = tile_scene
    probs = _probs(len(cams), 4, 11)
    acc, overflow = _fuse(renderer, vertices, cams, probs, aggregator)
    assert int(overflow) == 0
    assert tuple(acc.shape) == (renderer.getPrimitivesNum(), 4)
    np.testing.assert_allclose(
        acc.numpy(), _per_view(renderer, cams, probs, aggregator).numpy(),
        rtol=1e-6, atol=0)
    jacc, jov = _jax_fuse(jrenderer, cams, probs, aggregator)
    assert int(jov) == 0
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), rtol=RTOL,
                               atol=ATOL)
    seen = acc.abs().sum(-1) > 0
    assert 0.3 < seen.float().mean() < 1.0  # back texels stay unseen


@pytest.mark.parametrize("aggregator", ["sum", "mul"])
def test_dense_fuse_views_texels_matches_per_view_and_jax(
        dense_scene, aggregator, monkeypatch):
    """Cube s=37 (16428 faces) dispatches to the dense rasterizer under a
    texel plan (plan_fuse with allow_split=False, as bench.py plans
    texels); the JAX side runs its dense path op by op."""
    vertices, cams, renderer, jrenderer = dense_scene
    assert len(renderer.faces) >= render.rast.DENSE_THRESHOLD
    probs = _probs(len(cams), 3, 5)
    plan = distributed.plan_fuse(vertices, renderer.faces,
                                 *stack_cameras(cams), height=96, width=128,
                                 allow_split=False, device="cpu")
    assert plan.dense_e_cap.split_k == 0 and plan.remap is None
    assert plan.dense_e_cap.pairs > 0
    acc, overflow = _fuse(renderer, vertices, cams, probs, aggregator,
                          dense_e_cap=plan.dense_e_cap)
    assert int(overflow) == 0
    np.testing.assert_allclose(
        acc.numpy(), _per_view(renderer, cams, probs, aggregator).numpy(),
        rtol=1e-6, atol=0)
    monkeypatch.setenv("SM_RASTERIZER", "dense")
    with jax.disable_jit():
        jacc, jov = _jax_fuse(jrenderer, cams, probs, aggregator)
    assert int(jov) == 0
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), rtol=RTOL,
                               atol=ATOL)


def test_weights_and_predict_fn(tile_scene):
    vertices, cams, renderer, _ = tile_scene
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(
        rng.normal(size=(len(cams), 96, 128, 4)).astype(np.float32))
    weights = rng.uniform(0.5, 2.0, size=(len(cams), 96, 128)).astype(
        np.float32)
    a, _ = _fuse(renderer, vertices, cams, logits, "sum", weights=weights,
                 predict_fn=lambda x: torch.softmax(x, -1))
    probs = torch.softmax(logits, -1).numpy()
    b, _ = _fuse(renderer, vertices, cams, probs, "sum", weights=weights)
    assert torch.equal(a, b)
    np.testing.assert_allclose(
        a.numpy(), _per_view(renderer, cams, probs, "sum", weights).numpy(),
        rtol=1e-6, atol=0)
    assert not torch.equal(a, _fuse(renderer, vertices, cams, probs,
                                    "sum")[0])


def test_render_and_accumulate_prim_transform_hook(tile_scene):
    """The hook gets the rasterizer's (tri, depth, camera arrays) and its
    ids are what the view fuses; without it the triangle ids are."""
    vertices, cams, renderer, _ = tile_scene
    probs = _probs(1, 3, 0)[0]
    cam = render._camera_arrays(cams[0])
    seen = []

    def hook(tri, depth, camera_arrays):
        seen.append((tri.shape, depth.shape, camera_arrays is cam))
        return torch.where(tri >= 0, tri % 7, tri)

    kw = dict(num_primitives=7, aggregator="sum", height=96, width=128,
              device="cpu")
    faces = renderer.faces
    got, _ = distributed.render_and_accumulate(
        vertices, faces, cam, probs, None, 0.5, prim_transform=hook, **kw)
    assert seen == [((96, 128), (96, 128), True)]
    tri, _, _ = render.rast.rasterize(torch.from_numpy(vertices), faces, *cam,
                                      height=96, width=128, device="cpu")
    want = fusion._accumulate_view(
        torch.where(tri >= 0, tri % 7, tri), torch.from_numpy(probs), None,
        0.5, num_primitives=7, aggregator="sum")
    assert torch.equal(got, want)
    plain, _ = distributed.render_and_accumulate(
        vertices, faces, cam, probs, None, 0.5,
        **dict(kw, num_primitives=len(faces)))
    assert torch.equal(plain, fusion._accumulate_view(
        tri, torch.from_numpy(probs), None, 0.5, num_primitives=len(faces),
        aggregator="sum"))


def test_unported_fusion_options_raise(tile_scene):
    """Near-plane clipping (ported) fuses as the JAX package's clipped
    fuse_views_texels does; a lens (ported) fuses as the JAX package's
    fuse_views_texels does, and a zero lens gives the pinhole fusion's
    bits."""
    vertices, cams, renderer, jrenderer = tile_scene
    probs = _probs(len(cams), 2, 1)
    dist = np.zeros((len(cams), 4), np.float32)
    plain, _ = _fuse(renderer, vertices, cams, probs, "sum")
    for kw in (dict(distortions=dist), dict(shared_lens=True),
               dict(distortions=dist, shared_lens=True)):
        acc, ov = _fuse(renderer, vertices, cams, probs, "sum", **kw)
        assert int(ov) == 0 and torch.equal(acc, plain)
    dist[:, 0] = [0.05, -0.05, 0.02]
    acc, ov = _fuse(renderer, vertices, cams, probs, "sum", distortions=dist)
    jacc, _ = _jax_fuse(jrenderer, cams, probs, "sum", distortions=dist)
    assert int(ov) == 0 and not torch.equal(acc, plain)
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), rtol=RTOL,
                               atol=ATOL)
    acc, ov = _fuse(renderer, vertices, cams, probs, "sum", clip_near=True)
    jacc, _ = _jax_fuse(jrenderer, cams, probs, "sum", clip_near=True)
    assert int(ov) == 0
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), rtol=RTOL,
                               atol=ATOL)


def test_forced_dense_texel_plan_equals_per_view(tile_scene, monkeypatch):
    """A texel plan forced dense on a mesh under DENSE_THRESHOLD faces
    (cube s=3): fuse_views_texels(backend="dense") rasterizes with the
    dense rasterizer, once per view, and equals the per-view
    TexelsRenderer(backend="dense") -> add path bit for bit."""
    vertices, cams, renderer, _ = tile_scene
    assert len(renderer.faces) < render.rast.DENSE_THRESHOLD
    probs = _probs(len(cams), 3, 9)
    plan = distributed.plan_fuse(vertices, renderer.faces,
                                 *stack_cameras(cams), height=96, width=128,
                                 backend="dense", allow_split=False,
                                 device="cpu")
    assert plan.dense_e_cap is not None
    calls = []
    dense_rasterize = render.rast.dense.rasterize

    def counted(*args, **kwargs):
        calls.append(1)
        return dense_rasterize(*args, **kwargs)

    monkeypatch.setattr(render.rast.dense, "rasterize", counted)
    acc, overflow = _fuse(renderer, vertices, cams, probs, "sum",
                          backend="dense", dense_e_cap=plan.dense_e_cap)
    assert int(overflow) == 0 and len(calls) == len(cams)
    faces = testing.make_cube(subdivisions=3)[1]
    dense = render.texels(SimpleNamespace(vertices=vertices, faces=faces),
                          cams, 1.5, backend="dense", device="cpu")
    want = _per_view(dense, cams, probs, "sum")
    assert len(calls) == 2 * len(cams)
    assert torch.equal(acc, want)
