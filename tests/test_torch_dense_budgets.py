"""Parity of semantic_meshes_torch's dense rasterizer with the JAX package's
`rasterize/dense.py` on the CPU, at small sizes: pair and micro budgets,
the uni-slot prefix, tri_ids, the zero-budget path, and the streaming
z-resolve (kernel B) on its own.

Same conventions as test_torch_dense_raster.py: seeded numpy scenes from
tests/_torch_dense_scenes.py, JAX op by op, ids and overflow exact, depths
at rtol 2e-5. The two witnesses here show where the port and the jitted
JAX package part: XLA's FMA contraction in the setup (a pair count) and in
the interpret-mode kernel (depths).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dense_scenes as sc
from semantic_meshes.rasterize import dense as jdense
from semantic_meshes.rasterize import xla
from semantic_meshes_torch.rasterize import dense, dense_kernel, tile_kernel
from semantic_meshes_torch.rasterize import tiles

CASES = ["compaction_roomy", "compaction_starved", "split_k0", "split_kT",
         "split_probed", "split_tri_ids", "tri_ids_permuted",
         "zero_budget_pure_micro", "zero_budget_spills", "undersized_budget",
         "n_global_cap"]
DROPS = {"compaction_starved", "zero_budget_spills", "undersized_budget",
         "n_global_cap"}


@pytest.mark.parametrize("name", CASES)
def test_rasterize_matches_jax(name):
    v, f, cam, h, w, y_offset, kw = sc.case(name)
    want = sc.jax_rasterize(v, f, cam, h, w, y_offset, kw)
    got = dense.rasterize(v, f, *cam, y_offset, height=h, width=w,
                          device="cpu", **kw)
    sc.assert_images_match(want, got)
    ids, _, overflow = got
    assert (int(overflow) > 0) == (name in DROPS)
    if name != "zero_budget_pure_micro":
        assert bool((ids >= 0).any())


def test_tri_ids_remap_reproduces_unpermuted_image():
    """rasterize(faces[perm], tri_ids=perm) == rasterize(faces) bit for
    bit, with rows on both the fragment path and the kernel: ids are
    substituted where they are born, so ties break by the original id."""
    v, f, cam, h, w, _, kw = sc.case("tri_ids_permuted")
    perm = kw["tri_ids"]
    unperm = np.empty_like(perm)
    unperm[perm] = np.arange(len(perm), dtype=perm.dtype)
    faces = f[unperm]  # the original face order
    i0, z0, ov0 = dense.rasterize(v, faces, *cam, height=h, width=w,
                                  device="cpu")
    i1, z1, ov1 = dense.rasterize(v, f, *cam, height=h, width=w,
                                  device="cpu", **kw)
    assert torch.equal(i0, i1)
    assert torch.equal(z0.view(torch.int32), z1.view(torch.int32))
    assert int(ov0) == int(ov1) == 0
    micro = dense._classify(tiles.setup_inputs(v, faces, *cam, device="cpu"),
                            h, w, 0.0)[0]
    hit = torch.unique(i0[i0 >= 0]).long()
    assert bool(micro[hit].any()) and bool((~micro[hit]).any())


def test_exact_budget_is_bit_identical_and_undersized_counts():
    v, f, cam = sc.random_scene(seed=3)
    h, w = 64, 256
    count = int(dense.candidate_count(v, f, *cam, height=h, width=w,
                                      device="cpu"))
    a = dense.rasterize(v, f, *cam, height=h, width=w, device="cpu")
    b = dense.rasterize(v, f, *cam, height=h, width=w, e_cap_rows=count,
                        device="cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert int(b[2]) == 0
    assert count > dense.CHUNK
    c = dense.rasterize(v, f, *cam, height=h, width=w, e_cap_rows=1,
                        device="cpu")  # rounds up to one CHUNK
    assert int(c[2]) == count - dense.CHUNK


def test_split_and_compaction_are_exclusive_and_clipping_raises():
    """micro_split and micro_cap_rows are exclusive and micro_max is
    checked; clipping, once refused here, is ported and on this scene in
    front of the camera gives the culled render."""
    v, f = sc.uni_scene()
    cam = sc.ring_cam(256, 96)
    with pytest.raises(ValueError, match="mutually exclusive"):
        dense.rasterize(v, f, *cam, height=96, width=256, micro_split=4,
                        micro_cap_rows=8, device="cpu")
    # clipping (ported): every triangle lies in front of this camera, so
    # the clipped render is the culled one bit for bit, ids as JAX's
    clip = dense.rasterize(v, f, *cam, height=96, width=256, clip_near=True,
                           device="cpu")
    cull = dense.rasterize(v, f, *cam, height=96, width=256, device="cpu")
    assert torch.equal(clip[0], cull[0]) and int(clip[2]) == 0
    assert torch.equal(clip[1].view(torch.int32), cull[1].view(torch.int32))
    np.testing.assert_array_equal(clip[0].numpy(), np.asarray(xla.rasterize(
        v, f, *cam, height=96, width=256, clip_near=True)[0]))
    with pytest.raises(ValueError, match="micro_max"):
        dense.rasterize(v, f, *cam, height=96, width=256, micro_max=9,
                        device="cpu")


def test_pair_count_gap_is_xla_fma_contraction():
    """Witness for running JAX op by op: at this scene the jitted JAX
    package counts 4 pairs more than the port, because under jit XLA
    contracts the setup's a*b + c into FMAs, which moves some bboxes by an
    ulp across a tile boundary. Op by op, JAX's setup equals the port's
    bit for bit and both count the same pairs."""
    v, f, cam = sc.random_scene(seed=4)
    h, w = 64, 256
    port = int(dense.candidate_count(v, f, *cam, height=h, width=w,
                                     device="cpu"))
    jitted = int(jdense.candidate_count(v, f, *cam, height=h, width=w))
    with jax.disable_jit():
        eager = int(jdense.candidate_count(v, f, *cam, height=h, width=w))
    assert eager == port and jitted == port + 4
    own = tiles.setup_inputs(v, f, *cam, device="cpu")
    eager_setup = sc.torch_setup(sc.jax_setup(v, f, cam))
    jit_setup = jax.jit(xla.setup_from_face_vertices)(
        jnp.asarray(v[f]), *(jnp.asarray(c) for c in cam))
    for k in ("xmin", "xmax", "ymin", "ymax"):
        assert torch.equal(own[k].view(torch.int32),
                           eager_setup[k].view(torch.int32))
        assert not np.array_equal(np.asarray(jit_setup[k]), own[k].numpy())


KERNEL_CASES = {
    # (scene, camera, height, width, y_offset, micro_max)
    "mixed": lambda: (*sc.mixed_scene(), sc.simple_cam(256, 96), 96, 256,
                      0.0, 2),
    "mixed_all_kernel": lambda: (*sc.mixed_scene(), sc.simple_cam(256, 96),
                                 96, 256, 0.0, 1),
    "cube_band": lambda: (*sc.cube_with_quad(), sc.ring_cam(128, 96, 1, 4),
                          48, 128, 24.0, 1),
    "stacked_big": lambda: (*sc.stacked_big_scene(4), sc.simple_cam(256, 96),
                            48, 256, 0.0, 2),
}
E_CAP = 3 * 2048


@functools.lru_cache(maxsize=None)
def _kernel_case(name):
    v, f, cam, h, w, y_offset, micro_max = KERNEL_CASES[name]()
    setup = sc.jax_setup(v, f, cam)
    want = sc.jax_kernel_b(setup, h, w, y_offset, E_CAP, dense.N_GLOBAL,
                           micro_max)
    tsetup = sc.torch_setup(setup)
    sorted_ids, starts, overflow, _ = dense._build_sorted_bins(
        tsetup, h, w, y_offset, E_CAP, dense.N_GLOBAL, micro_max)
    assert int(overflow) == 0
    args = (tile_kernel.candidate_table(tsetup), sorted_ids, starts,
            dense.N_GLOBAL, None, y_offset, dense._cdiv(w, dense.TILE_W), h,
            w)
    return args, want


@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_resolve_dense_plain_matches_jax_kernel(name):
    """resolve_dense_plain (the function raster_dense.cu computes, before
    its micro merge) against JAX's kernel B, both fed the same setup and
    the same sorted binning."""
    args, (want_z, want_ids) = _kernel_case(name)
    z, ids = dense_kernel.resolve_dense_plain(*args)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    assert (want_ids >= 0).any()
    fin = np.isfinite(want_z)
    np.testing.assert_array_equal(np.isfinite(z.numpy()), fin)
    np.testing.assert_allclose(z.numpy()[fin], want_z[fin],
                               rtol=sc.DEPTH_RTOL)


def _resolve_contracted(table, sorted_ids, starts, n_global, micro_key,
                        y_offset, nbx, height, width):
    """resolve_dense_plain with each form evaluated as XLA's CPU backend
    contracts it, fma(a, px, b*py) + c: the f32 product a*px is exact in
    f64, so one f64 add and the cast to f32 round as the fma does (up to a
    double rounding, which these scenes do not hit)."""
    cand, counts = dense_kernel.candidates(sorted_ids, starts, n_global,
                                           table.shape[0] - 1)
    B = cand.shape[0]
    nby = B // nbx
    px, py = tile_kernel._pixel_centres(nby, nbx, y_offset, "cpu",
                                        dense.TILE_H)
    params = table[cand.long()]
    ids = params[..., 9].contiguous().view(torch.int32)
    invz = torch.zeros((B, dense.TILE_H, dense.TILE_W))
    idx = torch.full((B, dense.TILE_H, dense.TILE_W), -1, dtype=torch.int32)

    def form(p, k):
        a, b, c = (p[:, k + i, None, None] for i in range(3))
        return (a.double() * px.double() + (b * py).double()).float() + c

    for n in range(int(counts.max())):
        p = params[:, n]
        inv_zc = form(p, 10)
        ok = ((form(p, 0) >= 0.0) & (form(p, 3) >= 0.0) & (form(p, 6) >= 0.0)
              & (inv_zc > invz) & (n < counts)[:, None, None])
        invz = torch.where(ok, inv_zc, invz)
        idx = torch.where(ok, ids[:, n, None, None], idx)
    z = torch.where(invz > 0.0, torch.reciprocal(invz),
                    torch.full_like(invz, float("inf")))

    def image(t):
        return (t.reshape(nby, nbx, dense.TILE_H, dense.TILE_W)
                .permute(0, 2, 1, 3)
                .reshape(nby * dense.TILE_H, nbx * dense.TILE_W)
                [:height, :width])

    return image(z), image(idx)


@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_dense_depth_gap_is_xla_fma_contraction(name):
    """Witness for the depth tolerance: the port's resolve with XLA's
    contraction reproduces JAX's interpret-mode kernel B bit for bit, so
    the depth gap of the plain version is that contraction alone."""
    args, (want_z, want_ids) = _kernel_case(name)
    z, ids = _resolve_contracted(*args)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_array_equal(z.numpy().view(np.int32),
                                  want_z.view(np.int32))


def test_resolve_dense_dispatch_and_launch_count():
    """CPU tensors take the plain version and never count a launch; the
    CUDA entry refuses CPU tensors rather than fall back."""
    v, f = sc.mixed_scene()
    args, key, _ = dense.resolve_inputs(v, f, *sc.simple_cam(256, 96),
                                        height=96, width=256, device="cpu")
    before = dense_kernel.launches
    z, ids = dense_kernel.resolve_dense(*args)
    assert dense_kernel.launches == before
    zp, ip = dense_kernel.resolve_dense_plain(*args)
    assert torch.equal(ids, ip) and torch.equal(z, zp)
    with pytest.raises(ValueError, match="CUDA"):
        dense_kernel.resolve_dense_cuda(*args)
    zm, im = dense_kernel.decode_micro(torch.full(
        (2, 3), dense_kernel.BG_KEY, dtype=torch.int64))
    assert bool(torch.isinf(zm).all()) and bool((im == -1).all())
