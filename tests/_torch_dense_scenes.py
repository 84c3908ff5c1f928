"""Scenes and JAX reference runs shared by the dense-rasterizer parity tests
(tests/test_torch_dense_*.py), all made from fixed seeds with numpy.

The JAX side runs op by op (`jax.disable_jit()`): XLA then contracts
nothing in the triangle setup or the fragment path, which the port
reproduces bit for bit. Under jit, XLA's CPU backend contracts the setup's
a*b + c into FMAs, which moves a bbox by an ulp and can flip a tile or a
micro class at an exact boundary (test_pair_count_gap_is_xla_fma_contraction
is the witness). The interpret-mode Pallas kernel contracts its forms into
fma(a, px, b*py) + c even op by op, so kernel-path depths compare at
rtol 2e-5 (test_dense_depth_gap_is_xla_fma_contraction is the witness);
ids and overflow compare exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from semantic_meshes import testing as jtesting
from semantic_meshes.data import stack_cameras
from semantic_meshes.rasterize import dense as jdense
from semantic_meshes.rasterize import pallas_kernel, xla

DEPTH_RTOL = 2e-5


def simple_cam(w, h, f=40.0):
    return (np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
            np.array([f, f], np.float32),
            np.array([w / 2, h / 2], np.float32))


def ring_cam(w, h, view=0, num_views=1, **kw):
    cams = jtesting.make_ring_cameras(num_views=num_views, width=w, height=h,
                                      **kw)
    rot, trans, fl, pp = stack_cameras(cams)
    return rot[view], trans[view], fl[view], pp[view]


def _triangles(specs, seed, spread=0.8):
    """Right triangles of (count, [sizes], z0) groups at random centres."""
    rng = np.random.default_rng(seed)
    verts, tris = [], []
    for n, sizes, z0 in specs:
        for _ in range(n):
            c = rng.normal(size=3) * spread
            c[2] = z0 + rng.random()
            s = rng.choice(sizes)
            base = len(verts)
            verts += [c, c + [s, 0, 0], c + [0, s, 0]]
            tris.append([base, base + 1, base + 2])
    return verts, tris


def _with_big(verts, tris):
    base = len(verts)
    verts = verts + [[-4, -4, 7], [4, -4, 7], [0, 5, 7]]
    return (np.asarray(verts, np.float32),
            np.asarray(tris + [[base, base + 1, base + 2]], np.int32))


def mixed_scene():
    """Micro, small and big triangles (all three dense classes)."""
    return _with_big(*_triangles([(30, [0.01], 4.0), (10, [0.6], 5.0)],
                                 seed=3))


def routing_scene():
    """Sizes from sub-pixel to ~8 px bboxes, plus one big triangle."""
    return _with_big(*_triangles([(40, [0.01, 0.1, 0.3, 0.6], 4.0)], seed=7))


def uni_scene():
    return _with_big(*_triangles([(60, [0.004, 0.01, 0.2, 0.5], 4.0)],
                                 seed=5))


def compaction_scene():
    v, f = _triangles([(30, [0.15], 4.0)], seed=11, spread=0.6)
    return np.asarray(v, np.float32), np.asarray(f, np.int32)


def random_scene(seed, t=400):
    rng = np.random.default_rng(seed)
    vertices = rng.normal(size=(t, 3)).astype(np.float32) * 0.5
    vertices[:, 2] += 4.0
    faces = rng.integers(0, t, size=(t, 3)).astype(np.int32)
    cam = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
           np.array([80.0, 80.0], np.float32),
           np.array([64.0, 32.0], np.float32))
    return vertices, faces, cam


def pure_micro_scene():
    rng = np.random.default_rng(7)
    n = 300
    c = rng.normal(size=(n, 3)).astype(np.float32) * 0.8
    c[:, 2] = 4 + rng.random(n)
    vertices = np.concatenate([c, c + [0.01, 0, 0], c + [0, 0.01, 0]],
                              axis=0).astype(np.float32)
    faces = np.stack([np.arange(n), np.arange(n) + n, np.arange(n) + 2 * n],
                     -1).astype(np.int32)
    return vertices, faces


def stacked_big_scene(n_big=20):
    """n_big image-covering triangles; the nearest (id 0) wins everywhere."""
    verts, tris = [], []
    for i in range(n_big):
        z = 3.0 + 0.1 * i
        base = len(verts)
        verts += [[-40, -40, z], [40, -40, z], [0, 50, z]]
        tris.append([base, base + 1, base + 2])
    return np.asarray(verts, np.float32), np.asarray(tris, np.int32)


def cube_with_quad():
    """A sub-pixel cube (micro rows) plus a big quad (kernel rows)."""
    cv, cf = jtesting.make_cube(24)
    big_v = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                     np.float32) * 0.9
    big_f = np.array([[0, 1, 2], [0, 2, 3]], np.int32) + len(cv)
    return (np.concatenate([cv, big_v]).astype(np.float32),
            np.concatenate([cf, big_f]).astype(np.int32))


def uni_perm(v, f, cam, h, w):
    with jax.disable_jit():
        uni = np.asarray(jdense.uni_eligible(v, f, *cam, height=h, width=w))
    return np.argsort(~uni, kind="stable"), int(uni.sum())


def case(name):
    """(vertices, faces, camera, height, width, y_offset, keywords)."""
    if name == "mixed":
        v, f = mixed_scene()
        return v, f, simple_cam(256, 96), 96, 256, 0.0, {}
    if name.startswith("routing_m"):
        v, f = routing_scene()
        return v, f, simple_cam(256, 96), 96, 256, 0.0, dict(
            micro_max=int(name[len("routing_m"):]))
    if name == "cube_face_vertices":
        v, f = jtesting.make_cube(5)
        return v, f, ring_cam(256, 96), 96, 256, 0.0, dict(
            face_vertices=v[f])
    if name == "cube_band":
        v, f = jtesting.make_cube(4)
        return v, f, ring_cam(128, 96), 32, 128, 32.0, {}
    if name == "cube_band_m4":
        v, f = jtesting.make_cube(4)
        return v, f, ring_cam(128, 96), 32, 128, 32.0, dict(micro_max=4)
    if name == "background_fragments":
        v, f = jtesting.make_cube(subdivisions=30)  # 4 T * 2 >= H * W
        return v, f, ring_cam(128, 64), 64, 128, 0.0, {}
    if name == "compaction_roomy":
        v, f = compaction_scene()
        return v, f, simple_cam(256, 96), 96, 256, 0.0, dict(
            micro_max=4, micro_cap_rows=32)
    if name == "compaction_starved":
        v, f = compaction_scene()
        return v, f, simple_cam(256, 96), 96, 256, 0.0, dict(
            micro_max=4, micro_cap_rows=8)
    if name in ("split_k0", "split_kT"):
        v, f = uni_scene()
        k = 0 if name == "split_k0" else len(f)
        return v, f, ring_cam(256, 96), 96, 256, 0.0, dict(micro_split=k)
    if name in ("split_probed", "split_tri_ids"):
        v, f = uni_scene()
        cam = ring_cam(256, 96)
        perm, k = uni_perm(v, f, cam, 96, 256)
        assert 0 < k < len(f)
        kw = dict(micro_split=k)
        if name == "split_tri_ids":
            kw["tri_ids"] = perm.astype(np.int32)
        return v, f[perm], cam, 96, 256, 0.0, kw
    if name == "tri_ids_permuted":
        # view 1 of 4 sees both the micro cube and the quad
        v, f = cube_with_quad()
        perm = np.random.default_rng(0).permutation(len(f)).astype(np.int32)
        return v, f[perm], ring_cam(128, 96, 1, 4), 96, 128, 0.0, dict(
            tri_ids=perm)
    if name == "zero_budget_pure_micro":
        v, f = pure_micro_scene()
        return v, f, simple_cam(256, 96), 96, 256, 0.0, dict(e_cap_rows=0)
    if name == "zero_budget_spills":
        v = np.array([[0.04, 0.04, 4], [0.07, 0.04, 4], [0.04, 0.07, 4],
                      [0, 0, 5], [2, 0, 5], [0, 2, 5]], np.float32)
        f = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
        return v, f, simple_cam(128, 96), 96, 128, 0.0, dict(e_cap_rows=0)
    if name == "undersized_budget":
        v, f, cam = random_scene(seed=4)
        return v, f, cam, 64, 256, 0.0, dict(e_cap_rows=1)
    if name == "n_global_cap":
        v, f = stacked_big_scene()
        return v, f, simple_cam(256, 96), 96, 256, 0.0, dict(n_global=1)
    raise KeyError(name)


def jax_rasterize(v, f, cam, h, w, y_offset, kw):
    """JAX's dense.rasterize, op by op."""
    kw = dict(kw)
    if "tri_ids" in kw:
        kw["tri_ids"] = jnp.asarray(kw["tri_ids"])
    with jax.disable_jit():
        out = jdense.rasterize(v, f, *cam, np.float32(y_offset), height=h,
                               width=w, **kw)
    return tuple(np.asarray(x) for x in out)


def assert_images_match(want, got):
    wi, wz, wo = want
    gi, gz, go = (x.numpy() for x in got)
    np.testing.assert_array_equal(gi, wi)
    fin = np.isfinite(wz)
    np.testing.assert_array_equal(np.isfinite(gz), fin)
    np.testing.assert_allclose(gz[fin], wz[fin], rtol=DEPTH_RTOL)
    assert int(go) == int(wo)


def jax_setup(v, f, cam):
    """The JAX package's setup, op by op."""
    with jax.disable_jit():
        return xla.setup_from_face_vertices(jnp.asarray(v[f]),
                                            *(jnp.asarray(c) for c in cam))


def torch_setup(setup):
    return {k: torch.from_numpy(np.array(x)) for k, x in setup.items()}


def jax_kernel_b(setup, h, w, y_offset, e_cap, n_global, micro_max):
    """JAX's kernel B alone, op by op in interpret mode, on the binning of
    `setup`: the pallas_call of dense.rasterize without the micro merge.
    Returns (depth, ids) images."""
    nby, nbx = -(-h // jdense.TILE_H), -(-w // jdense.TILE_W)
    B = nby * nbx
    block = pl.BlockSpec((1, jdense.TILE_H, jdense.TILE_W),
                         lambda b: (b, 0, 0), memory_space=pltpu.VMEM)
    tile = jax.ShapeDtypeStruct
    with jax.disable_jit():
        tri_sorted, starts, _, _ = jdense._build_sorted_bins(
            setup, h, w, jnp.float32(y_offset), e_cap, n_global, micro_max)
        table = pallas_kernel._gather_candidate_tables(
            setup, tri_sorted[None, :])[0].reshape(-1, jdense.PACK * 16)
        z, ids = pl.pallas_call(
            jdense._make_dense_kernel(nbx, B, n_global),
            grid=(B,),
            in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                      pl.BlockSpec(memory_space=pltpu.SMEM),
                      pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=[block, block],
            out_shape=[
                tile((B, jdense.TILE_H, jdense.TILE_W), jnp.float32),
                tile((B, jdense.TILE_H, jdense.TILE_W), jnp.int32)],
            scratch_shapes=[
                pltpu.SMEM((2, jdense.CHUNK_ROWS, jdense.PACK * 16),
                           jnp.float32),
                pltpu.SemaphoreType.DMA((2,))],
            interpret=True,
        )(jnp.full((1, 1), y_offset, jnp.float32), starts, table)

    def image(t):
        return (np.asarray(t).reshape(nby, nbx, jdense.TILE_H, jdense.TILE_W)
                .transpose(0, 2, 1, 3)
                .reshape(nby * jdense.TILE_H, nbx * jdense.TILE_W)[:h, :w])

    return image(z), image(ids)
