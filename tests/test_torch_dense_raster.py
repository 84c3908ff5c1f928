"""Parity of semantic_meshes_torch's dense rasterizer with the JAX package's
`rasterize/dense.py` on the CPU, at small sizes: the triangle classes, the
routing thresholds, row bands and both of the JAX fragment path's branches.

The same seeded numpy scenes (tests/_torch_dense_scenes.py) go through
JAX's `dense.rasterize`, op by op with its Pallas kernel in interpret mode,
and the port's with `device="cpu"` (the streaming z-resolve's plain PyTorch
version and the micro-fragment scatter). Ids and overflow compare exactly,
depths at rtol 2e-5 (see the scenes module for why).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dense_scenes as sc
from semantic_meshes import testing as jtesting
from semantic_meshes.rasterize import dense as jdense
from semantic_meshes_torch.rasterize import dense, dense_kernel

CASES = ["mixed", "routing_m1", "routing_m2", "routing_m4", "routing_m6",
         "cube_face_vertices", "cube_band", "cube_band_m4",
         "background_fragments"]


@pytest.mark.parametrize("name", CASES)
def test_rasterize_matches_jax(name):
    v, f, cam, h, w, y_offset, kw = sc.case(name)
    want = sc.jax_rasterize(v, f, cam, h, w, y_offset, kw)
    got = dense.rasterize(v, f, *cam, y_offset, height=h, width=w,
                          device="cpu", **kw)
    sc.assert_images_match(want, got)
    ids, _, overflow = got
    assert ids.dtype == torch.int32 and tuple(ids.shape) == (h, w)
    assert bool((ids >= 0).any()) and int(overflow) == 0


@pytest.mark.parametrize("name", ["background_fragments", "routing_m2"])
def test_micro_image_matches_jax_op_by_op(name):
    """The fragment path alone, fed the same setup: the port's amin scatter
    of packed (z bits, id) keys equals both of the JAX package's sort
    branches (background fragments for the subdivided cube, set-scatter
    for the scene of mixed sizes) bit for bit."""
    v, f, cam, h, w, y_offset, kw = sc.case(name)
    setup = sc.jax_setup(v, f, cam)
    tsetup = sc.torch_setup(setup)
    for m in (2, 3, 4):
        with jax.disable_jit():
            micro = jdense._classify(setup, h, w, jnp.float32(y_offset),
                                     m)[0]
            want_z, want_i = jdense._rasterize_micro(
                setup, micro, h, w, jnp.float32(y_offset), micro_max=m)
        n_frag = m * m * len(f)
        assert (n_frag * 2 >= h * w) == (name == "background_fragments")
        tmicro = dense._classify(tsetup, h, w, y_offset, m)[0]
        np.testing.assert_array_equal(tmicro.numpy(), np.asarray(micro))
        key = dense._rasterize_micro(tsetup, tmicro, h, w, y_offset,
                                     micro_max=m)
        z, ids = dense_kernel.decode_micro(key)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(z.numpy().view(np.int32),
                                      np.asarray(want_z).view(np.int32))
        assert bool((ids >= 0).any())


def test_band_equals_rows_of_full_image():
    v, f = jtesting.make_cube(4)
    cam = sc.ring_cam(128, 96)
    full = dense.rasterize(v, f, *cam, height=96, width=128, device="cpu")
    for m in (None, 4):
        band = dense.rasterize(v, f, *cam, 32.0, height=32, width=128,
                               micro_max=m, device="cpu")
        assert torch.equal(band[0], full[0][32:64])


def test_routing_and_budgets_are_output_invariant():
    """micro_max, a tight pair budget, compaction and the uni prefix only
    move work between the paths: the ids never change, nothing drops."""
    v, f = sc.routing_scene()
    cam = sc.simple_cam(256, 96)
    base = dense.rasterize(v, f, *cam, height=96, width=256, device="cpu")
    pairs = int(dense.candidate_count(v, f, *cam, height=96, width=256,
                                      device="cpu"))
    variants = [dict(micro_max=m) for m in (1, 3, 5, 8)] + [
        dict(e_cap_rows=pairs), dict(micro_cap_rows=64),
        dict(micro_split=len(f) // 2)]
    for kw in variants:
        ids, _, ov = dense.rasterize(v, f, *cam, height=96, width=256,
                                     device="cpu", **kw)
        assert torch.equal(ids, base[0]), kw
        assert int(ov) == 0, kw


def test_n_global_zero_drops_exactly_the_big_triangles():
    """n_global=0 tests no global-bucket candidate: the image is that of
    the mesh without its big triangle, which overflow counts. The JAX
    kernel reads each chunk in whole rows of 8 candidates, so its last
    tile also tests the first ids of the global bucket; the port tests
    exactly the ranges, so this case is held against the mesh itself."""
    v, f = sc.mixed_scene()
    cam = sc.simple_cam(256, 96)
    ids, z, ov = dense.rasterize(v, f, *cam, height=96, width=256,
                                 n_global=0, device="cpu")
    want_ids, want_z, want_ov = dense.rasterize(
        v, f[:-1], *cam, height=96, width=256, device="cpu")
    assert int(ov) == 1 and int(want_ov) == 0
    assert torch.equal(ids, want_ids)
    assert torch.equal(z, want_z)
    full = dense.rasterize(v, f, *cam, height=96, width=256, device="cpu")
    assert bool((full[0] == len(f) - 1).any())  # the big one is visible


def test_micro_pixel_range_saturates_like_xla():
    """Off-screen and non-finite bboxes convert to int32 as XLA does
    (saturating, NaN -> 0), and nx, ny wrap as int32 differences."""
    vals = np.array([-1e12, -3.7, 0.2, 5.5, 1e12, np.inf, -np.inf, np.nan],
                    np.float32)
    lo, hi = np.meshgrid(vals, vals)
    setup = {k: jnp.asarray(x.ravel()) for k, x in
             (("xmin", lo), ("xmax", hi), ("ymin", hi), ("ymax", lo))}
    with jax.disable_jit():
        want = [np.asarray(x) for x in jdense._micro_pixel_range(setup)]
    got = dense._micro_pixel_range(sc.torch_setup(setup))
    for g, wnt in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), wnt)
