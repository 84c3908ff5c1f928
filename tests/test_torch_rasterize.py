"""Parity of semantic_meshes_torch's tile rasterizer (setup, candidate
table, binning, plain z-resolve, dispatch) with the JAX package, on the CPU.

The JAX side runs its Pallas kernel in interpret mode and its XLA oracle.
Depth tolerance: XLA's CPU backend contracts a*b + c into one FMA, in the
resolve's forms (a*px + b*py + c becomes fma(a, px, b*py) + c, even with
jit disabled) and, under jit, in the setup; the port rounds every multiply
and add on its own (the rounding its CUDA kernel reproduces bit for bit).
The inverse-depth plane cancels heavily at pixel centres, which magnifies
those last-bit differences, so depths compare at rtol 2e-5 and not 1e-6.
test_depth_gap_is_xla_fma_contraction is the witness: the two setups agree
bit for bit, and the port's resolve with XLA's contraction reproduces the
JAX resolve bit for bit. Ids, empty masks and overflow compare exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semantic_meshes import testing as jtesting
from semantic_meshes.data import stack_cameras
from semantic_meshes.rasterize import pallas_kernel, xla
from semantic_meshes_torch import rasterize as trast
from semantic_meshes_torch.rasterize import tile_kernel, tiles

DEPTH_RTOL = 2e-5


def _random_scene(hw, seed=9, n_verts=80, n_faces=60):
    rng = np.random.default_rng(seed)
    vertices = rng.normal(size=(n_verts, 3)).astype(np.float32) * 1.5
    vertices[:, 2] += 5
    faces = rng.integers(0, n_verts, size=(n_faces, 3)).astype(np.int32)
    h, w = hw
    cam = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
           np.array([50.0, 50.0], np.float32),
           np.array([w / 2, h / 2], np.float32))
    return vertices, faces, cam


def _cube_scene():
    vertices, faces = jtesting.make_cube(5)
    cams = jtesting.make_ring_cameras(num_views=1, width=128, height=96)
    rot, trans, fl, pp = stack_cameras(cams)
    return vertices, faces, (rot[0], trans[0], fl[0], pp[0])


def _jax_setup(vertices, faces, cam):
    """The JAX package's setup, run op by op (not under jit), so it can be
    handed to both sides unchanged."""
    return xla.setup_from_face_vertices(
        jnp.asarray(vertices[faces]), *(jnp.asarray(c) for c in cam)
    )


def _torch_setup(setup):
    return {k: torch.from_numpy(np.array(v)) for k, v in setup.items()}


def _assert_images_match(jax_out, torch_out):
    ti, td, to = (np.asarray(x) for x in jax_out)
    pi, pd, po = (x.numpy() for x in torch_out)
    np.testing.assert_array_equal(pi, ti)
    fin = np.isfinite(td)
    np.testing.assert_array_equal(np.isfinite(pd), fin)
    np.testing.assert_allclose(pd[fin], td[fin], rtol=DEPTH_RTOL)
    assert int(po) == int(to)


SCENES = {
    "random_96x128": lambda: (_random_scene((96, 128)), (96, 128)),
    "random_64x256": lambda: (_random_scene((64, 256)), (64, 256)),
    "cube_96x128": lambda: (_cube_scene(), (96, 128)),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_candidate_table_matches_pallas(name):
    (vertices, faces, cam), (h, w) = SCENES[name]()
    setup = _jax_setup(vertices, faces, cam)
    cand, _, _ = xla._bin_triangles(setup, h, w, 256, jnp.float32(0.0))
    want = np.asarray(pallas_kernel._gather_candidate_tables(setup, cand))
    want_ids = want[..., 9].view(np.int32) - pallas_kernel._ID_BIAS
    T = len(faces)
    # same setup on both sides: the two tables must agree exactly
    table = tile_kernel.candidate_table(_torch_setup(setup))
    assert table.shape == (T + 1, 16)
    got = table[torch.from_numpy(np.array(cand)).long()].numpy()
    lanes = [k for k in range(16) if k != 9]
    np.testing.assert_array_equal(got[..., lanes], want[..., lanes])
    # ids: unbiased on the port's side; the sentinel slots (cand == T) hold
    # a raw 0 on both sides (the JAX table never biases its sentinel)
    real = np.asarray(cand) < T
    got_ids = got[..., 9].view(np.int32)
    np.testing.assert_array_equal(got_ids[real], want_ids[real])
    np.testing.assert_array_equal(got_ids[~real], 0)
    np.testing.assert_array_equal(want[..., 9].view(np.int32)[~real], 0)
    # sentinel row: never inside
    sent = table[T].numpy()
    np.testing.assert_array_equal(sent[[2, 5, 8]], [-1.0, -1.0, -1.0])
    assert sent.view(np.int32)[9] == 0
    # each side's own setup: floats within rounding
    own = tile_kernel.candidate_table(tiles.setup_from_face_vertices(
        torch.from_numpy(vertices[faces]),
        *(torch.from_numpy(np.asarray(c)) for c in cam)))
    np.testing.assert_allclose(own[:, lanes].numpy(),
                               table[:, lanes].numpy(), rtol=1e-5)
    np.testing.assert_array_equal(own[:, 9].numpy().view(np.int32),
                                  np.append(np.arange(T), 0))


@pytest.mark.parametrize("name", sorted(SCENES))
@pytest.mark.parametrize("cap", [256, 3])
def test_bin_triangles_matches_jax(name, cap):
    (vertices, faces, cam), (h, w) = SCENES[name]()
    setup = _jax_setup(vertices, faces, cam)
    cand, counts, overflow = xla._bin_triangles(setup, h, w, cap,
                                                jnp.float32(0.0))
    pc, pn, po = tiles._bin_triangles(_torch_setup(setup), h, w, cap, 0.0)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(cand))
    np.testing.assert_array_equal(pn.numpy(), np.asarray(counts))
    assert int(po) == int(overflow)
    if cap == 3:
        assert int(po) > 0  # the small cap really drops pairs


def test_bin_triangles_saturates_far_off_screen():
    """A valid triangle reaching far beyond the screen covers the edge
    tiles (float -> int saturates, as XLA's convert does)."""
    big = 1e12
    setup = dict(
        denom=torch.tensor([1.0]), valid=torch.tensor([True]),
        xmin=torch.tensor([-big]), xmax=torch.tensor([big]),
        ymin=torch.tensor([10.0]), ymax=torch.tensor([big]),
    )
    cand, counts, overflow = tiles._bin_triangles(setup, 64, 256, 256, 0.0)
    np.testing.assert_array_equal(counts.numpy(), [1, 1, 1, 1])
    assert int(overflow) == 0


@pytest.mark.parametrize("hw", [(96, 128), (64, 256)])
@pytest.mark.parametrize("oracle", ["pallas", "xla"])
def test_plain_resolve_matches_jax_random_scene(hw, oracle):
    vertices, faces, cam = _random_scene(hw)
    h, w = hw
    mod = pallas_kernel if oracle == "pallas" else xla
    _assert_images_match(
        mod.rasterize(vertices, faces, *cam, height=h, width=w),
        trast.rasterize(vertices, faces, *cam, height=h, width=w,
                        device="cpu"),
    )


@pytest.mark.parametrize("oracle", ["pallas", "xla"])
def test_plain_resolve_matches_jax_cube_band(oracle):
    vertices, faces, cam = _cube_scene()
    mod = pallas_kernel if oracle == "pallas" else xla
    band = trast.rasterize(vertices, faces, *cam, 32.0, height=32,
                           width=128, device="cpu")
    _assert_images_match(
        mod.rasterize(vertices, faces, *cam, np.float32(32.0), height=32,
                      width=128),
        band,
    )
    full = trast.rasterize(vertices, faces, *cam, height=96, width=128,
                           device="cpu")
    # the band equals the corresponding rows of the full image
    assert torch.equal(band[0], full[0][32:64])
    assert torch.equal(band[1], full[1][32:64])


def _resolve_contracted(table, cand, counts, nbx, height, width):
    """resolve_tiles_plain with each form evaluated as XLA's CPU backend
    contracts it: fma(a, px, b*py) + c. The f32 product a*px is exact in
    f64, so one f64 add and the cast to f32 round as the fma does (up to a
    double rounding, which these scenes do not hit)."""
    B = cand.shape[0]
    nby = B // nbx
    px, py = tile_kernel._pixel_centres(nby, nbx, 0.0, "cpu")
    params = table[cand.long()]
    ids = params[..., 9].contiguous().view(torch.int32)
    invz = torch.zeros((B, tiles.TILE_H, tiles.TILE_W))
    idx = torch.full((B, tiles.TILE_H, tiles.TILE_W), -1, dtype=torch.int32)

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
        return (t.reshape(nby, nbx, tiles.TILE_H, tiles.TILE_W)
                .permute(0, 2, 1, 3)
                .reshape(nby * tiles.TILE_H, nbx * tiles.TILE_W)
                [:height, :width])

    return image(z), image(idx)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_depth_gap_is_xla_fma_contraction(name):
    """Witness for DEPTH_RTOL: the port's own setup equals the JAX
    package's (op by op) bit for bit, and the JAX Pallas resolve run
    without jit equals the port's resolve with XLA's contraction bit for
    bit. So the depth gap is XLA's FMA contraction alone."""
    (vertices, faces, cam), (h, w) = SCENES[name]()
    setup = _torch_setup(_jax_setup(vertices, faces, cam))
    table = tile_kernel.candidate_table(setup)
    own = tile_kernel.candidate_table(tiles.setup_from_face_vertices(
        torch.from_numpy(vertices[faces]),
        *(torch.from_numpy(np.asarray(c)) for c in cam)))
    assert torch.equal(own.view(torch.int32), table.view(torch.int32))
    cand, counts, _ = tiles._bin_triangles(setup, h, w, 256, 0.0)
    z, ids = _resolve_contracted(table, cand, counts, tiles._cdiv(w, 128),
                                 h, w)
    with jax.disable_jit():
        want_ids, want_z, _ = pallas_kernel.rasterize(
            vertices, faces, *cam, height=h, width=w)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(z.numpy().view(np.int32),
                                  np.asarray(want_z).view(np.int32))


def test_face_vertices_path_equals_gather_path():
    vertices, faces, cam = _cube_scene()
    a = trast.rasterize(vertices, faces, *cam, height=96, width=128,
                        device="cpu")
    b = trast.rasterize(vertices, faces, *cam, face_vertices=vertices[faces],
                        height=96, width=128, device="cpu")
    assert torch.equal(a[0], b[0])
    assert torch.equal(a[1], b[1])


def test_tri_ids_remap_matches_jax():
    vertices, faces, cam = _random_scene((96, 128))
    rng = np.random.default_rng(1)
    tri_ids = rng.permutation(1000)[: len(faces)].astype(np.int32)
    from semantic_meshes import rasterize as jrast

    want = jrast.rasterize(vertices, faces, *cam, height=96, width=128,
                           tri_ids=tri_ids, backend="xla")
    got = trast.rasterize(vertices, faces, *cam, height=96, width=128,
                          tri_ids=tri_ids, device="cpu")
    _assert_images_match(want, got)


def test_dispatch_refuses_dense_size_meshes(monkeypatch):
    """Dispatch refuses unknown backends only: a mesh of DENSE_THRESHOLD
    faces goes to the dense rasterizer unless the tile one is asked for
    (by the port's name or the JAX package's, "pallas" or "xla")."""
    monkeypatch.delenv("SM_RASTERIZER", raising=False)
    n = trast.DENSE_THRESHOLD
    faces = np.zeros((n, 3), np.int32)
    vertices = np.zeros((3, 3), np.float32)
    cam = _random_scene((32, 128))[2]
    assert trast.check_backend(n) == "dense"
    assert trast.check_backend(n - 1) == "tile"
    assert trast.check_backend(n, "xla") == trast.check_backend(
        n, "pallas") == "tile"
    with pytest.raises(ValueError, match="unknown rasterizer backend"):
        trast.rasterize(vertices, faces, *cam, height=32, width=128,
                        backend="vulkan", device="cpu")
    for backend in (None, "dense", "tile", "xla"):  # degenerate faces: empty
        ids, _, overflow = trast.rasterize(vertices, faces, *cam, height=32,
                                           width=128, backend=backend,
                                           device="cpu")
        assert bool((ids == -1).all()) and int(overflow) == 0


def test_cpu_resolve_never_counts_launches_and_cuda_path_refuses_cpu():
    vertices, faces, cam = _random_scene((64, 128))
    before = tile_kernel.launches
    trast.rasterize(vertices, faces, *cam, height=64, width=128,
                    device="cpu")
    assert tile_kernel.launches == before
    table = torch.zeros((2, 16))
    cand = torch.zeros((1, 1), dtype=torch.int32)
    counts = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tile_kernel.resolve_tiles_cuda(table, cand, counts, 0.0, 1, 32, 128)
    # the clipped path (ported) counts no launch on the CPU either, and
    # gives JAX's ids
    ids, _, _ = trast.rasterize(vertices, faces, *cam, height=64, width=128,
                                clip_near=True, device="cpu")
    assert tile_kernel.launches == before
    np.testing.assert_array_equal(ids.numpy(), np.asarray(xla.rasterize(
        vertices, faces, *cam, height=64, width=128, clip_near=True)[0]))
