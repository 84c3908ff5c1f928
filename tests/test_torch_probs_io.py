"""Wire formats for precomputed probability maps (semantic_meshes_torch.
probs_io) against the JAX package's probs_io on the same seeded maps.

Mirrors tests/test_probs_io.py's 17 tests (its numpy oracles and error
bounds, unchanged), and adds parity: densify, the wire casts (bf16 bits
included: both sides round to nearest even) and load equal the JAX
package's bit for bit (op by op where jitted XLA contracts an FMA); the
batched top-k fusion equals the JAX scan at rtol 1e-5, atol 1e-6 (the
segment sums add in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semantic_meshes import distributed as jdistributed
from semantic_meshes import probs_io as jprobs_io
from semantic_meshes import testing as jtesting
from semantic_meshes.data import stack_cameras as jstack_cameras
from semantic_meshes_torch import data, distributed, fusion, probs_io, testing

CPU = "cpu"


def _softmax_maps(h=7, w=5, c=19, seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, (h, w, c)).astype(np.float32)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _topk_arrays(probs, k):
    part = np.argpartition(probs, -k, axis=-1)[..., -k:]
    vals = np.take_along_axis(probs, part, axis=-1)
    order = np.argsort(-vals, axis=-1)
    idx = np.take_along_axis(part, order, axis=-1).astype(np.uint8)
    return np.take_along_axis(vals, order, axis=-1), idx


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _topk(vals, idx, c):
    return probs_io.TopKProbs(_t(vals), _t(idx), c)


def _jax_densify(vals, idx, c):
    return np.asarray(jprobs_io.densify(jprobs_io.TopKProbs(
        jnp.asarray(vals), jnp.asarray(idx), c)))


class TestQuantize:
    def test_u8_roundtrip_error_bound(self):
        probs = _softmax_maps()
        q = probs_io.quantize_u8(probs)
        assert q.dtype == np.uint8
        back = q.astype(np.float32) / 255.0
        assert np.abs(back - probs).max() <= 0.5 / 255.0 + 1e-7
        np.testing.assert_array_equal(q, jprobs_io.quantize_u8(probs))

    def test_u8_saturates_at_one(self):
        assert probs_io.quantize_u8(np.array([1.0, 0.0]))[0] == 255


class TestDensify:
    def test_dense_f16_matches_f32(self):
        probs = _softmax_maps()
        out = probs_io.densify(probs.astype(np.float16), device=CPU)
        assert out.dtype == torch.float32 and out.device.type == "cpu"
        np.testing.assert_allclose(out.numpy(), probs, atol=2 ** -11)
        np.testing.assert_array_equal(
            out.numpy(), np.asarray(jprobs_io.densify(
                probs.astype(np.float16))))

    def test_dense_u8_dequantizes(self):
        probs = _softmax_maps()
        q = probs_io.quantize_u8(probs)
        out = probs_io.densify(q, device=CPU).numpy()
        np.testing.assert_allclose(out, probs, atol=1 / 510 + 1e-6)
        np.testing.assert_array_equal(out, np.asarray(jprobs_io.densify(q)))

    def test_topk_full_k_is_exact_to_quantization(self):
        """K = classes keeps everything: densify == dequantized dense."""
        probs = _softmax_maps(c=6)
        vals, idx = _topk_arrays(probs, 6)
        q = probs_io.quantize_u8(vals)
        out = probs_io.densify(_topk(q, idx, 6)).numpy()
        np.testing.assert_allclose(out, probs, atol=1 / 510 + 1e-6)
        np.testing.assert_array_equal(out, _jax_densify(q, idx, 6))

    def test_topk_drops_only_the_tail(self):
        """K < classes: kept classes match the original; dropped classes
        get the uniform residual floor (1-s)/(C-K), not exact zero, which
        aggregator='mul' would turn into a permanent veto."""
        probs = _softmax_maps()
        k = 4
        c = probs.shape[-1]
        vals, idx = _topk_arrays(probs, k)
        v16 = vals.astype(np.float16)
        out = probs_io.densify(_topk(v16, idx, c)).numpy()
        oracle = np.zeros_like(probs)
        np.put_along_axis(oracle, idx.astype(np.int64), vals, axis=-1)
        s = oracle.sum(-1, keepdims=True)
        floor = np.maximum(1.0 - s, 0.0) / (c - k)
        oracle = np.where(s <= 0.5, oracle, np.maximum(oracle, floor))
        np.testing.assert_allclose(out, oracle, atol=2 ** -10)
        # every pixel's map still sums to ~1 (retained + spread residual)
        np.testing.assert_allclose(out.sum(-1), 1.0, atol=k * 2 ** -10)
        np.testing.assert_array_equal(out, _jax_densify(v16, idx, c))

    def test_topk_dont_care_pixels_stay_zero(self):
        """All-zero value rows (padding views, and any pixel whose
        retained mass fails sum > 0.5) densify to sums <= 0.5, so the
        fusion don't-care rule (ref: fusion/Mesh.h:98) still skips them."""
        c, k = 9, 3
        vals = np.zeros((4, 5, k), np.float16)
        vals[0, 0] = [0.4, 0.05, 0.0]  # sum 0.45 <= 0.5: don't-care
        idx = np.tile(np.arange(k, dtype=np.uint8), (4, 5, 1))
        out = probs_io.densify(_topk(vals, idx, c)).numpy()
        assert (out.sum(-1) <= 0.5).all()
        np.testing.assert_allclose(out[0, 0, :k], [0.4, 0.05, 0.0],
                                   atol=2 ** -11)
        assert (out[1:] == 0).all()
        np.testing.assert_array_equal(out, _jax_densify(vals, idx, c))

    def test_topk_mul_fusion_does_not_veto_dropped_classes(self):
        """aggregator='mul' with top-k maps: a class dropped from one
        view's top-K survives fusion when other views support it."""
        c, k = 10, 3
        rng = np.random.default_rng(11)
        p1 = np.full((4, 4, c), 0.02, np.float32)
        p1[..., 7] = 1.0 - 0.02 * (c - 1)
        p2 = rng.uniform(0.01, 0.02, (4, 4, c)).astype(np.float32)
        p2[..., 0] = 0.5
        p2[..., 1] = 0.3
        p2 /= p2.sum(-1, keepdims=True)
        prim = np.zeros((4, 4), np.uint32)  # all pixels -> primitive 0

        def fuse2(maps):
            agg = fusion.MeshAggregator(primitives=1, classes=c,
                                        aggregator="mul", device=CPU)
            for m in maps:
                agg.add(prim.T, _t(m).permute(1, 0, 2))
            return agg.get().numpy()

        dense = fuse2([p1, p2])
        tks = []
        for m in (p1, p2):
            vals, idx = _topk_arrays(m, k)
            tks.append(probs_io.densify(
                _topk(vals.astype(np.float16), idx, c)).numpy())
        assert (tks[1][..., 7] > 0).all()  # the floor, not a veto zero
        sparse = fuse2(tks)
        assert dense[0].argmax() == sparse[0].argmax() == 7

    def test_u8_topk_residual_bits_equal_jax_op_by_op(self):
        """u8 values with a residual floor (the scannet wire): bit-equal
        to the JAX package op by op (the retained sum added in K order on
        both sides). Jitted, XLA contracts the dequantizing multiply into
        the sum as an FMA, which moves the floor by an ulp on ~6% of the
        values: equal there at rtol 1e-6."""
        probs = _softmax_maps(h=31, w=17, c=40, seed=9)
        vals, idx = _topk_arrays(probs, 3)
        q = probs_io.quantize_u8(vals)
        out = probs_io.densify(_topk(q, idx, 40)).numpy()
        with jax.disable_jit():
            np.testing.assert_array_equal(out, _jax_densify(q, idx, 40))
        np.testing.assert_allclose(out, _jax_densify(q, idx, 40),
                                   rtol=1e-6, atol=0)


class TestLoad:
    def test_load_dense_casts_wire(self, tmp_path):
        probs = _softmax_maps()
        np.save(tmp_path / "f.npy", probs)  # f32 on disk
        loaded = probs_io.load(str(tmp_path / "f"), wire="f16", device=CPU)
        assert loaded.dtype == torch.float16
        out = probs_io.densify(loaded).numpy()
        np.testing.assert_allclose(out, probs, atol=2 ** -11)

    def test_load_dense_u8_disk_to_wider_wire_dequantizes(self, tmp_path):
        probs = _softmax_maps()
        np.save(tmp_path / "q.npy", probs_io.quantize_u8(probs))
        loaded = probs_io.load(str(tmp_path / "q"), wire="f32", device=CPU)
        assert loaded.dtype == torch.float32
        np.testing.assert_allclose(loaded.numpy(), probs,
                                   atol=1 / 510 + 1e-6)

    def test_load_prefers_npz(self, tmp_path):
        probs = _softmax_maps(c=8)
        vals, idx = _topk_arrays(probs, 3)
        np.save(tmp_path / "m.npy", probs)
        np.savez(tmp_path / "m.npz", values=vals.astype(np.float16),
                 indices=idx, classes=np.int32(8))
        loaded = probs_io.load(str(tmp_path / "m"), device=CPU)
        assert isinstance(loaded, probs_io.TopKProbs)
        assert loaded.classes == 8
        assert loaded.values.dtype == torch.float16
        assert loaded.indices.dtype == torch.uint8
        np.testing.assert_array_equal(loaded.indices.numpy(), idx)

    def test_load_missing_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            probs_io.load(str(tmp_path / "absent"), device=CPU)

    @pytest.mark.parametrize("disk", ["f32", "u8"])
    @pytest.mark.parametrize("wire", ["f32", "f16", "bf16", "u8"])
    def test_load_wire_bits_equal_jax(self, tmp_path, disk, wire):
        """Every wire from either stored dtype: the same bits as the JAX
        package's load (bf16 compared as its 16-bit patterns)."""
        probs = _softmax_maps(h=13, w=11, seed=4)
        stored = probs if disk == "f32" else probs_io.quantize_u8(probs)
        np.save(tmp_path / "p.npy", stored)
        got = probs_io.load(str(tmp_path / "p"), wire=wire, device=CPU)
        want = np.asarray(jprobs_io.load(str(tmp_path / "p"), wire=wire))
        if wire == "bf16":
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          want.view(np.int16))
        else:
            assert got.numpy().dtype == want.dtype
            np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            probs_io.densify(got).numpy(),
            np.asarray(jprobs_io.densify(jnp.asarray(want))))

    def test_cuda_load_without_a_card_raises(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("this machine has a card")
        np.save(tmp_path / "p.npy", _softmax_maps())
        with pytest.raises(RuntimeError, match="is_available"):
            probs_io.load(str(tmp_path / "p"))


class TestFusionParity:
    def test_topk_fusion_close_to_dense_for_peaked_maps(self):
        """Fusing top-6 maps approximates dense fusion: the fused argmax
        matches almost everywhere."""
        probs = _softmax_maps(h=16, w=16, c=19, seed=3)
        vals, idx = _topk_arrays(probs, 6)
        prim = np.arange(16 * 16, dtype=np.uint32).reshape(16, 16) % 40

        def fuse(p_hwc):
            agg = fusion.MeshAggregator(primitives=40, classes=19,
                                        aggregator="sum", device=CPU)
            agg.add(prim.T, p_hwc.permute(1, 0, 2))
            return agg.get().numpy()

        dense = fuse(_t(probs))
        sparse = fuse(probs_io.densify(
            _topk(probs_io.quantize_u8(vals), idx, 19)))
        assert (dense.argmax(-1) == sparse.argmax(-1)).mean() > 0.95


class TestTopKDensify:
    """TopKDensify: the stable predict_fn for the batched fusions."""

    def test_matches_densify(self):
        probs = _softmax_maps(seed=5)
        vals, idx = _topk_arrays(probs, 4)
        t = _topk(vals.astype(np.float16), idx, 19)
        via_class = probs_io.TopKDensify(19)((t.values, t.indices))
        assert torch.equal(via_class, probs_io.densify(t))

    def test_equal_instances_hash_equal(self):
        a, b = probs_io.TopKDensify(19), probs_io.TopKDensify(19)
        assert a == b and hash(a) == hash(b)
        assert a != probs_io.TopKDensify(20)
        assert a != probs_io.densify

    def test_weakrefable(self):
        import weakref

        d = probs_io.TopKDensify(19)
        assert weakref.ref(d)() is d

    def test_fuse_views_scan_with_topk_predict_fn(self):
        """Through the batched fusion: stacked top-k pairs + TopKDensify
        equal the JAX scan, and the per-view dense fusion; an all-zero pad
        view contributes nothing (fails the don't-care test, ref:
        fusion/Mesh.h:98). Before fuse_views sliced each leaf of a tuple
        per view, view 0 got the whole values stack and view 1 the whole
        indices stack."""
        vertices, faces = testing.make_cube(2)
        W = H = 24
        cams = testing.make_ring_cameras(num_views=2, width=W, height=H)
        C, k = 19, 3
        rng = np.random.default_rng(7)
        logits = rng.normal(0, 2, (2, H, W, C)).astype(np.float32)
        e = np.exp(logits - logits.max(-1, keepdims=True))
        probs = e / e.sum(-1, keepdims=True)
        vals = np.empty((2, H, W, k), np.float16)
        idxs = np.empty((2, H, W, k), np.uint8)
        for i in range(2):
            v, ix = _topk_arrays(probs[i], k)
            vals[i], idxs[i] = v.astype(np.float16), ix
        # pad with a zero view (the ragged-tail convention of the demo)
        vals_p = np.concatenate([vals, np.zeros_like(vals[:1])])
        idxs_p = np.concatenate([idxs, np.zeros_like(idxs[:1])])
        rot, trans, fl, pp = (np.concatenate([a, a[-1:]])
                              for a in data.stack_cameras(cams))
        P = len(faces)
        acc, overflow = distributed.fuse_views(
            vertices, faces, rot, trans, fl, pp, (_t(vals_p), _t(idxs_p)),
            0.5, None, num_primitives=P, aggregator="sum", height=H,
            width=W, predict_fn=probs_io.TopKDensify(C), device=CPU,
        )
        assert int(overflow) == 0
        # the same batch as a list of stacks, and through texel mode's entry
        acc_list, _ = distributed.fuse_views(
            vertices, faces, rot, trans, fl, pp, [_t(vals_p), _t(idxs_p)],
            0.5, num_primitives=P, aggregator="sum", height=H, width=W,
            predict_fn=probs_io.TopKDensify(C), device=CPU,
        )
        assert torch.equal(acc, acc_list)
        # oracle 1: the port's batch over pre-densified maps, no pad view
        dense = torch.stack([probs_io.densify(_topk(vals[i], idxs[i], C))
                             for i in range(2)])
        ref, _ = distributed.fuse_views(
            vertices, faces, *data.stack_cameras(cams), dense, 0.5,
            num_primitives=P, aggregator="sum", height=H, width=W,
            device=CPU,
        )
        assert torch.equal(acc, ref)
        # oracle 2: the JAX scan with its TopKDensify on the same inputs
        jrot, jtrans, jfl, jpp = jstack_cameras(
            jtesting.make_ring_cameras(num_views=2, width=W, height=H))
        jacc, jov = jdistributed.fuse_views(
            jnp.asarray(vertices), jnp.asarray(faces),
            jnp.concatenate([jrot, jrot[-1:]]),
            jnp.concatenate([jtrans, jtrans[-1:]]),
            jnp.concatenate([jfl, jfl[-1:]]),
            jnp.concatenate([jpp, jpp[-1:]]),
            (jnp.asarray(vals_p), jnp.asarray(idxs_p)), jnp.float32(0.5),
            None, num_primitives=P, aggregator="sum", height=H, width=W,
            predict_fn=jprobs_io.TopKDensify(C),
        )
        assert int(jov) == 0
        np.testing.assert_allclose(acc.numpy(), np.asarray(jacc),
                                   rtol=1e-5, atol=1e-6)

    def test_texel_and_planned_fusions_pass_tuple_probs(self):
        """fuse_views_texels and fuse_views_split hand a tuple `probs`
        through to fuse_views unchanged: equal to their densified runs."""
        vertices, faces = testing.make_cube(2)
        W, H, C, k = 32, 24, 7, 2
        cams = testing.make_ring_cameras(num_views=2, width=W, height=H)
        rng = np.random.default_rng(2)
        maps = np.stack([testing.random_probs(rng, H, W, C)
                         for _ in cams])
        vals = np.empty((2, H, W, k), np.float16)
        idxs = np.empty((2, H, W, k), np.uint8)
        for i in range(2):
            v, ix = _topk_arrays(maps[i], k)
            vals[i], idxs[i] = v.astype(np.float16), ix
        dense = torch.stack([probs_io.densify(_topk(vals[i], idxs[i], C))
                             for i in range(2)])
        arrays = data.stack_cameras(cams)
        kw = dict(num_primitives=len(faces), aggregator="sum", height=H,
                  width=W, device=CPU)
        pair = (_t(vals), _t(idxs))
        got, _ = distributed.fuse_views_split(
            vertices, faces, *arrays, pair, 0.5,
            predict_fn=probs_io.TopKDensify(C), **kw)
        want, _ = distributed.fuse_views_split(
            vertices, faces, *arrays, dense, 0.5, **kw)
        assert torch.equal(got, want)
        res = np.ones(len(faces), np.int32)
        first = np.arange(len(faces), dtype=np.int32)
        got, _ = distributed.fuse_views_texels(
            vertices, faces, res, first, *arrays, pair, 0.5,
            predict_fn=probs_io.TopKDensify(C), **kw)
        want, _ = distributed.fuse_views_texels(
            vertices, faces, res, first, *arrays, dense, 0.5, **kw)
        assert torch.equal(got, want)
