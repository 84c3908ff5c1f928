"""End-to-end parity of semantic_meshes_torch with the JAX package on the
synthetic cube scene, on the CPU: mesh -> render -> fuse -> colours -> PLY,
and the batched pipeline (plan_fuse + fuse_views_planned).

Ids compare exactly; fused arrays at rtol 1e-5, atol 1e-6 (another
summation order); depths at rtol 5e-5 (see test_torch_rasterize.py)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import semantic_meshes
from semantic_meshes import distributed as jdist
from semantic_meshes import testing as jtesting
from semantic_meshes.data import stack_cameras
from semantic_meshes_torch import convert, data, distributed, fusion, render
from semantic_meshes_torch import testing
from semantic_meshes_torch.io.ply import read_ply, write_mesh

RTOL, ATOL = 1e-5, 1e-6
DEPTH_RTOL = 5e-5


@pytest.fixture(scope="module")
def cube_scene():
    vertices, faces = testing.make_cube(subdivisions=5)  # 300 tris
    cams = testing.make_ring_cameras(num_views=4, width=160, height=128)
    return vertices, faces, cams


def _write_cube(tmp_path, vertices, faces):
    p = tmp_path / "cube.ply"
    write_mesh(p, vertices, faces)
    return data.Ply(str(p))


class TestCubeEndToEnd:
    def test_full_pipeline_recovers_face_classes(self, tmp_path, cube_scene):
        """Each cube side gets its own class; after rendering 4 views and
        fusing perfect one-hot masks, every triangle that was seen must
        recover its side's class — and the colours equal the JAX
        package's on the same views."""
        vertices, faces, cams = cube_scene
        mesh = _write_cube(tmp_path, vertices, faces)
        renderer = render.triangles(mesh, device="cpu")
        jmesh = semantic_meshes.data.Ply(mesh.path)
        jrenderer = semantic_meshes.render.triangles(jmesh)
        T = renderer.getPrimitivesNum()
        assert T == jrenderer.getPrimitivesNum() == len(faces)
        tris_per_side = T // 6
        tri_class = (np.arange(T) // tris_per_side).astype(np.int64)
        C = 6

        agg = fusion.MeshAggregator(primitives=T, classes=C,
                                    aggregator="sum", device="cpu")
        jagg = semantic_meshes.fusion.MeshAggregator(T, C, "sum")
        seen = np.zeros(T, bool)
        for cam in cams:
            idx, depth = renderer.render(cam)
            jidx, jdepth = jrenderer.render(cam)
            assert idx.dtype == torch.uint32 and depth.dtype == torch.float32
            assert tuple(idx.shape) == (cam.width, cam.height)
            idx_wh = idx.view(torch.int32).numpy().view(np.uint32)
            np.testing.assert_array_equal(idx_wh, np.asarray(jidx))
            jd = np.asarray(jdepth)
            fin = np.isfinite(jd)
            np.testing.assert_array_equal(np.isfinite(depth.numpy()), fin)
            np.testing.assert_allclose(depth.numpy()[fin], jd[fin],
                                       rtol=DEPTH_RTOL)
            idx_hw = idx_wh.T
            covered = idx_hw != 0xFFFFFFFF
            assert covered.mean() > 0.05
            ids = idx_hw[covered]
            seen[ids] = True
            mask = np.zeros(idx_hw.shape, np.int64)
            mask[covered] = tri_class[ids]
            probs = np.eye(C, dtype=np.float32)[mask]
            probs[~covered] = 0.0  # background = don't care
            agg.add(idx, probs.transpose(1, 0, 2))
            jagg.add(jidx, probs.transpose(1, 0, 2))

        fused = agg.get().numpy()
        np.testing.assert_allclose(fused, np.asarray(jagg.get()), rtol=RTOL,
                                   atol=ATOL)
        assert seen.sum() > T * 0.5
        np.testing.assert_array_equal(fused[seen].argmax(-1), tri_class[seen])
        np.testing.assert_allclose(fused[seen].max(-1), 1.0, atol=1e-5)
        assert np.all(fused[~seen].sum(-1) < 1e-6)

        # save + reload colorized mesh
        palette = (np.arange(1, 7)[:, None] * np.array([37, 59, 83])) % 256
        colors = palette[fused.argmax(-1)].astype(np.uint8)
        colors[~seen] = 0
        mesh.save(str(tmp_path / "cube_colorized.ply"), colors)
        m2 = data.Ply(str(tmp_path / "cube_colorized.ply"))
        np.testing.assert_array_equal(m2.faces, np.asarray(mesh.faces))
        face = read_ply(tmp_path / "cube_colorized.ply")["face"].data
        np.testing.assert_array_equal(
            np.stack([face["red"], face["green"], face["blue"]], -1), colors
        )

    def test_depth_is_cube_surface(self, tmp_path, cube_scene):
        vertices, faces, cams = cube_scene
        mesh = _write_cube(tmp_path, vertices, faces)
        _, depth = render.triangles(mesh, device="cpu").render(cams[0])
        depth = depth.numpy().T
        finite = np.isfinite(depth)
        # camera ring radius 3, cube half-size 0.5 -> depth in [2.3, 3.7]
        assert finite.any()
        assert depth[finite].min() > 2.0
        assert depth[finite].max() < 4.0

    def test_render_many_equals_render(self, tmp_path, cube_scene):
        vertices, faces, cams = cube_scene
        renderer = render.triangles(_write_cube(tmp_path, vertices, faces),
                                    device="cpu")
        ids, depth = renderer.render_many(cams)
        assert ids.dtype == torch.uint32 and tuple(ids.shape) == (4, 160, 128)
        for k, cam in enumerate(cams):
            i1, d1 = renderer.render(cam)
            assert torch.equal(ids[k].view(torch.int32), i1.view(torch.int32))
            assert torch.equal(depth[k], d1)
        renderer.prepare(cams)  # no-op for the tile rasterizer
        assert renderer.overflow_total() == 0

    def test_renderer_overflow_total_matches_jax(self, tmp_path, cube_scene,
                                                 caplog):
        vertices, faces, cams = cube_scene
        mesh = _write_cube(tmp_path, vertices, faces)
        renderer = render.triangles(mesh, max_tris_per_tile=4, device="cpu")
        jrenderer = semantic_meshes.render.triangles(
            semantic_meshes.data.Ply(mesh.path), max_tris_per_tile=4)
        with caplog.at_level("WARNING", logger="semantic_meshes_torch"):
            for cam in cams:
                renderer.render(cam)
                jrenderer.render(cam)
        assert "raise max_tris_per_tile (current 4)" in caplog.text
        assert renderer.overflow_total() == jrenderer.overflow_total() > 0


@pytest.mark.parametrize("aggregator", ["sum", "summax", "mul"])
def test_fused_state_matches_jax_on_same_views(cube_scene, tmp_path,
                                               aggregator):
    vertices, faces, cams = cube_scene
    mesh = _write_cube(tmp_path, vertices, faces)
    renderer = render.triangles(mesh, device="cpu")
    jrenderer = semantic_meshes.render.triangles(
        semantic_meshes.data.Ply(mesh.path)
    )
    rng = np.random.default_rng(3)
    agg = fusion.MeshAggregator(len(faces), 7, aggregator, 0.5, device="cpu")
    jagg = semantic_meshes.fusion.MeshAggregator(len(faces), 7, aggregator,
                                                 0.5)
    for cam in cams:
        probs = jtesting.random_probs(rng, cam.width, cam.height, 7, 0.2)
        agg.add(renderer.render(cam)[0], probs)
        jagg.add(jrenderer.render(cam)[0], probs)
    np.testing.assert_allclose(agg.state.numpy(), np.asarray(jagg.state),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(agg.get().numpy(), np.asarray(jagg.get()),
                               rtol=RTOL, atol=ATOL)


class TestBatchedPipeline:
    @pytest.mark.parametrize("agg_name", ["sum", "mul"])
    @pytest.mark.parametrize("weighted", [False, True])
    def test_planned_equals_per_view_and_jax(self, cube_scene, tmp_path,
                                             agg_name, weighted):
        vertices, faces, cams = cube_scene
        rng = np.random.default_rng(0)
        C, H, W = 5, 128, 160
        probs = np.stack([jtesting.random_probs(rng, H, W, C, 0.1)
                          for _ in cams])
        weights = (rng.uniform(0.5, 2.0, size=(len(cams), H, W)).astype(
            np.float32) if weighted else None)
        rot, trans, fl, pp = stack_cameras(cams)
        T = len(faces)

        plan = distributed.plan_fuse(vertices, faces, rot, trans, fl, pp,
                                     height=H, width=W, device="cpu")
        acc, overflow = distributed.fuse_views_planned(
            plan, vertices, rot, trans, fl, pp, probs, 0.5, weights,
            num_primitives=T, aggregator=agg_name, height=H, width=W,
            device="cpu",
        )
        assert int(overflow) == 0

        # the per-view public path gives the same accumulator
        renderer = render.triangles(_write_cube(tmp_path, vertices, faces),
                                    device="cpu")
        agg = fusion.MeshAggregator(T, C, agg_name, 0.5, device="cpu")
        for k, cam in enumerate(cams):
            agg.add(renderer.render(cam)[0], probs[k].transpose(1, 0, 2),
                    None if weights is None else weights[k].T)
        np.testing.assert_allclose(acc.numpy(), agg.state.numpy(),
                                   rtol=1e-6, atol=0)

        # and the JAX package's batched pipeline, on the same inputs
        jplan = jdist.plan_fuse(vertices, faces, rot, trans, fl, pp,
                                height=H, width=W)
        jacc, jov = jdist.fuse_views_planned(
            jplan, vertices, rot, trans, fl, pp, probs, np.float32(0.5),
            weights, num_primitives=T, aggregator=agg_name, height=H,
            width=W,
        )
        assert int(jov) == 0
        np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), rtol=RTOL,
                                   atol=ATOL)

    def test_overflow_is_counted_like_jax(self, cube_scene):
        vertices, faces, cams = cube_scene
        rng = np.random.default_rng(1)
        probs = np.stack([jtesting.random_probs(rng, 128, 160, 3)
                          for _ in cams[:2]])
        rot, trans, fl, pp = stack_cameras(cams[:2])
        kw = dict(num_primitives=len(faces), aggregator="sum", height=128,
                  width=160, max_tris_per_tile=4)
        acc, ov = distributed.fuse_views(vertices, faces, rot, trans, fl, pp,
                                         probs, 0.5, device="cpu", **kw)
        jacc, jov = jdist.fuse_views(vertices, faces, rot, trans, fl, pp,
                                     probs, np.float32(0.5), **kw)
        assert int(ov) == int(jov) > 0
        np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), rtol=RTOL,
                                   atol=ATOL)

    def test_predict_fn_hook(self, cube_scene):
        vertices, faces, cams = cube_scene
        rot, trans, fl, pp = stack_cameras(cams[:2])
        rng = np.random.default_rng(2)
        logits = torch.from_numpy(
            rng.normal(size=(2, 128, 160, 4)).astype(np.float32))
        kw = dict(num_primitives=len(faces), aggregator="sum", height=128,
                  width=160, device="cpu")
        a, _ = distributed.fuse_views(
            vertices, faces, rot, trans, fl, pp, logits, 0.5,
            predict_fn=lambda x: torch.softmax(x, -1), **kw)
        b, _ = distributed.fuse_views(
            vertices, faces, rot, trans, fl, pp, torch.softmax(logits, -1),
            0.5, **kw)
        assert torch.equal(a, b)


def test_unported_features_raise(tmp_path, cube_scene):
    """Near-plane clipping (ported) renders JAX's clipped ids, through the
    dense rasterizer too; a lens (ported) renders JAX's ids."""
    vertices, faces, cams = cube_scene
    mesh = _write_cube(tmp_path, vertices, faces)
    renderer = render.triangles(mesh, device="cpu")
    cam = cams[0]
    lens = data.Camera(cam.rotation, cam.translation, cam.resolution,
                       cam.focal_lengths, cam.principal_point,
                       distortion=[0.01, 0, 0, 0])
    jrenderer = semantic_meshes.render.triangles(
        semantic_meshes.data.Ply(mesh.path))
    jlens = semantic_meshes.data.Camera(
        cam.rotation, cam.translation, cam.resolution, cam.focal_lengths,
        cam.principal_point, distortion=[0.01, 0, 0, 0])
    ids, depth = renderer.render(lens)
    jids, jdepth = jrenderer.render(jlens)
    np.testing.assert_array_equal(
        ids.view(torch.int32).numpy().view(np.uint32), np.asarray(jids))
    fin = np.isfinite(np.asarray(jdepth))
    np.testing.assert_array_equal(np.isfinite(depth.numpy()), fin)
    np.testing.assert_allclose(depth.numpy()[fin], np.asarray(jdepth)[fin],
                               rtol=DEPTH_RTOL)
    renderer.prepare([cam, lens])  # a no-op for the tile rasterizer
    # clipping (ported): the clipped render equals JAX's
    jcam = semantic_meshes.data.Camera(
        cam.rotation, cam.translation, cam.resolution, cam.focal_lengths,
        cam.principal_point)
    ids, depth = render.triangles(mesh, clip_near=True,
                                  device="cpu").render(cam)
    jids, jdepth = semantic_meshes.render.triangles(
        semantic_meshes.data.Ply(mesh.path), clip_near=True).render(jcam)
    np.testing.assert_array_equal(
        ids.view(torch.int32).numpy().view(np.uint32), np.asarray(jids))
    fin = np.isfinite(np.asarray(jdepth))
    np.testing.assert_allclose(depth.numpy()[fin], np.asarray(jdepth)[fin],
                               rtol=DEPTH_RTOL)
    # a mesh of DENSE_THRESHOLD faces goes to the dense rasterizer (these
    # faces are degenerate: nothing is drawn, through a lens too, as in
    # JAX); clipping still raises
    big = convert.ply(mesh)
    big.faces = np.zeros((16384, 3), np.int32)
    dense_renderer = render.triangles(big, device="cpu")
    ids, _ = dense_renderer.render(cam)
    assert bool((ids.view(torch.int32) == -1).all())
    assert dense_renderer.dense_cap_policy._cap[(cam.height, cam.width)]
    ids, depth = dense_renderer.render(lens)
    jbig = semantic_meshes.render.triangles(SimpleNamespace(
        vertices=big.vertices, faces=big.faces), backend="dense")
    jids, _ = jbig.render(jlens)
    np.testing.assert_array_equal(
        ids.view(torch.int32).numpy().view(np.uint32), np.asarray(jids))
    assert bool(torch.isinf(depth).all())
    # clipped through the dense rasterizer: still nothing drawn, as in JAX
    clipped = render.triangles(big, clip_near=True, device="cpu")
    ids, depth = clipped.render(cam)
    assert bool((ids.view(torch.int32) == -1).all())
    assert bool(torch.isinf(depth).all()) and clipped.overflow_total() == 0
    budget = clipped.dense_cap_policy._cap[(cam.height, cam.width)]
    assert (budget.pairs, budget.micro) == (0, 0)
    assert render.triangles(big, backend="tile",
                            device="cpu").getPrimitivesNum() == 16384
    rot, trans, fl, pp = stack_cameras(cams)
    plan = distributed.plan_fuse(vertices, big.faces, rot, trans, fl, pp,
                                 height=128, width=160, device="cpu")
    assert plan.dense_e_cap == render.rast.dense.DenseBudget(0, 0, 2)


def test_convert_camera_and_ply(tmp_path, cube_scene):
    vertices, faces, cams = cube_scene
    jcam = jtesting.make_ring_cameras(1, 160, 128)[0]
    cam = convert.camera(jcam)
    for k in ("rotation", "translation", "focal_lengths", "principal_point",
              "distortion"):
        np.testing.assert_array_equal(getattr(cam, k), getattr(jcam, k))
    assert cam.resolution == jcam.resolution
    p = tmp_path / "m.ply"
    write_mesh(p, vertices, faces)
    mesh = convert.ply(semantic_meshes.data.Ply(str(p)))
    np.testing.assert_array_equal(mesh.vertices, vertices)
    np.testing.assert_array_equal(mesh.faces, faces)
    ids, _ = render.triangles(mesh, device="cpu").render(cam)
    jids, _ = semantic_meshes.render.triangles(
        semantic_meshes.data.Ply(str(p))).render(jcam)
    np.testing.assert_array_equal(
        ids.view(torch.int32).numpy().view(np.uint32), np.asarray(jids))
