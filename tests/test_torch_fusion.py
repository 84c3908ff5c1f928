"""Parity of semantic_meshes_torch's fusion (segment_sum, MeshAggregator,
ModelRenderer, convert) with the JAX package, on the CPU.

Tolerance rtol 1e-5, atol 1e-6: both sides add the same f32 values, but
the JAX side reduces through a one-hot matmul (small P) and the port
through a sorted segmented sum, so the additions happen in another order.
"""

import numpy as np
import pytest
import torch

from semantic_meshes import fusion as jfusion
from semantic_meshes import ops as jops
from semantic_meshes import testing as jtesting
from semantic_meshes_torch import convert, fusion, fusion_kernel, ops

RTOL, ATOL = 1e-5, 1e-6
P, C, W, H = 40, 5, 24, 16


def _view(seed, dont_care=0.3):
    """(W, H) uint32 ids with background, out-of-range ids and don't-care
    pixels, (W, H, C) probs and (W, H) weights, from numpy."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, P, size=(W, H)).astype(np.uint32)
    ids[rng.random((W, H)) < 0.2] = 0xFFFFFFFF  # background
    ids[rng.random((W, H)) < 0.05] = P + 3  # out of range
    ids[0, 0] = 0x80000001  # reads negative through an int32 view
    probs = jtesting.random_probs(rng, W, H, C, dont_care_frac=dont_care)
    weights = rng.uniform(0.2, 2.0, size=(W, H)).astype(np.float32)
    return ids, probs, weights


def test_segment_sum_matches_jax_and_numpy():
    rng = np.random.default_rng(0)
    n, d, p = 3000, 7, 97
    data = rng.normal(size=(n, d)).astype(np.float32)
    idx = rng.integers(-5, p + 5, size=n).astype(np.int32)
    want = np.zeros((p, d))
    ok = (idx >= 0) & (idx < p)
    np.add.at(want, idx[ok], data[ok].astype(np.float64))
    got = ops.segment_sum(torch.from_numpy(data), torch.from_numpy(idx), p)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jops.segment_sum(data, idx, p)),
        rtol=RTOL, atol=ATOL,
    )
    one = ops.segment_sum(torch.from_numpy(data[:, 0]),
                          torch.from_numpy(idx), p)
    np.testing.assert_allclose(one.numpy(), want[:, 0], rtol=RTOL, atol=ATOL)
    # deterministic: the same call twice is bit-identical
    again = ops.segment_sum(torch.from_numpy(data), torch.from_numpy(idx), p)
    assert torch.equal(got, again)


def test_segment_sum_empty_and_all_dropped():
    data = torch.ones((6, 2))
    idx = torch.tensor([-1, 9, 9, -3, 100, 4])
    out = ops.segment_sum(data, idx, 4)
    assert torch.equal(out, torch.zeros((4, 2)))


@pytest.mark.parametrize("aggregator", ["sum", "summax", "mul"])
@pytest.mark.parametrize("iew", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("weighted", [False, True])
def test_mesh_aggregator_matches_jax(aggregator, iew, weighted):
    want = jfusion.MeshAggregator(P, C, aggregator, iew)
    got = fusion.MeshAggregator(P, C, aggregator, iew, device="cpu")
    for seed in range(3):
        ids, probs, weights = _view(seed)
        w = weights if weighted else None
        want.add(ids, probs, w)
        got.add(ids, probs, w)
    np.testing.assert_allclose(got.state.numpy(), np.asarray(want.state),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.get().numpy(), np.asarray(want.get()),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("aggregator", ["sum", "mul"])
def test_id_dtypes_agree(aggregator):
    ids, probs, weights = _view(7)
    ref = fusion.MeshAggregator(P, C, aggregator, device="cpu")
    ref.add(ids, probs, weights)
    as_int64 = ids.view(np.int32).astype(np.int64)  # -1 background
    variants = [
        torch.from_numpy(ids.view(np.int32)).view(torch.uint32),
        torch.from_numpy(ids.view(np.int32)),
        torch.from_numpy(as_int64),
        ids.view(np.int32),
        as_int64,
    ]
    for v in variants:
        agg = fusion.MeshAggregator(P, C, aggregator, device="cpu")
        agg.add(v, torch.from_numpy(probs), torch.from_numpy(weights))
        assert torch.equal(agg.state, ref.state)


def test_add_many_equals_sequential_adds():
    views = [_view(s) for s in range(3)]
    seq = fusion.MeshAggregator(P, C, "summax", 0.5, device="cpu")
    for ids, probs, weights in views:
        seq.add(ids, probs, weights)
    many = fusion.MeshAggregator(P, C, "summax", 0.5, device="cpu")
    many.add_many(np.stack([v[0] for v in views]),
                  np.stack([v[1] for v in views]),
                  np.stack([v[2] for v in views]))
    assert torch.equal(many.state, seq.state)


def _chain_before_the_card_kernels(prim, probs, weights, iew, aggregator):
    """One view's fusion as the port computed it on every device before
    fusion got its card kernels, written out to pin its bits."""
    prim_flat = prim.reshape(-1)
    npix = prim_flat.shape[0]
    in_range = (prim_flat >= 0) & (prim_flat < P)
    idx = torch.where(in_range, prim_flat, P)
    probs_flat = probs.reshape(npix, C)
    not_dont_care = probs_flat.sum(dim=-1) > 0.5
    pixel_w = (torch.ones(npix) if weights is None
               else weights.reshape(npix))
    base_w = torch.where(in_range & not_dont_care, pixel_w,
                         torch.zeros_like(pixel_w))
    values = fusion._pixel_values(probs_flat, base_w, aggregator)
    data = torch.cat([values, in_range.to(torch.float32)[:, None]], dim=1)
    seg = ops.segment_sum(data, idx, P)
    counts = torch.clamp(seg[:, C], min=1.0)
    mix = torch.div(torch.full_like(counts, iew), counts) + (1.0 - iew)
    return mix[:, None] * seg[:, :C]


@pytest.mark.parametrize("aggregator", ["sum", "summax", "mul"])
@pytest.mark.parametrize("weighted", [False, True])
def test_cpu_fusion_keeps_the_plain_chain(aggregator, weighted):
    """On the CPU, _accumulate_view is the plain chain, bit for bit, and
    launches no kernel."""
    ids, probs, weights = _view(11)
    prim = fusion.as_ids(ids, "cpu").t()
    pr = torch.from_numpy(probs).transpose(0, 1)
    w = torch.from_numpy(weights).t() if weighted else None
    launches, views = fusion_kernel.launches, fusion_kernel.views
    got = fusion._accumulate_view(prim, pr, w, 0.3, num_primitives=P,
                                  aggregator=aggregator)
    want = _chain_before_the_card_kernels(prim, pr, w, 0.3, aggregator)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert (fusion_kernel.launches, fusion_kernel.views) == (launches, views)
    assert fusion_kernel.launches == 0


def test_state_merge_reset_and_convert():
    ids, probs, weights = _view(11)
    ids2, probs2, _ = _view(12)
    jagg = jfusion.MeshAggregator(P, C, "mul", 0.25)
    jagg.add(ids, probs, weights)
    agg = convert.mesh_aggregator(jagg, device="cpu")
    assert (agg.primitives, agg.classes, agg.aggregator,
            agg.images_equal_weight) == (P, C, "mul", 0.25)
    np.testing.assert_array_equal(agg.state.numpy(), np.asarray(jagg.state))
    # continue fusing on both sides from the same state
    jagg.add(ids2, probs2)
    agg.add(ids2, probs2)
    np.testing.assert_allclose(agg.get().numpy(), np.asarray(jagg.get()),
                               rtol=RTOL, atol=ATOL)
    other = fusion.MeshAggregator(P, C, "mul", 0.25, device="cpu")
    other.add(ids2, probs2)
    before = agg.state.clone()
    agg.merge(other.state)
    assert torch.equal(agg.state, before + other.state)
    with pytest.raises(ValueError, match="state must be"):
        agg.state = np.zeros((P + 1, C), np.float32)
    agg.reset()
    assert not agg.state.any()


def test_model_renderer_matches_jax():
    rng = np.random.default_rng(4)
    ann = rng.random((P, C)).astype(np.float32)
    ids, _, _ = _view(5)
    bg = np.arange(C, dtype=np.float32)
    want = jfusion.ModelRenderer(ann).render(ids, background=bg)
    got = fusion.ModelRenderer(torch.from_numpy(ann), device="cpu").render(
        ids, background=bg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jfusion.ModelRenderer(ann).render(ids)
    # a numpy table works too
    got = fusion.ModelRenderer(ann, device="cpu").render(ids)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_aggregator_renderer_snapshot():
    ids, probs, _ = _view(6, dont_care=0.0)
    agg = fusion.MeshAggregator(P, C, device="cpu")
    agg.add(ids, probs)
    img = agg.renderer().render(ids)
    assert img.shape == (W, H, C)
    fused = agg.get()
    valid = ids.view(np.int32)
    valid = (valid >= 0) & (valid < P)
    np.testing.assert_array_equal(
        img.numpy()[valid], fused.numpy()[ids[valid].astype(np.int64)]
    )


def test_input_validation():
    agg = fusion.MeshAggregator(P, C, device="cpu")
    ids, probs, weights = _view(0)
    with pytest.raises(ValueError, match="same width and height"):
        agg.add(ids[:-1], probs)
    with pytest.raises(ValueError, match="classes"):
        agg.add(ids, probs[..., :-1])
    with pytest.raises(ValueError, match="weights image"):
        agg.add(ids, probs, weights[:, :-1])
    with pytest.raises(ValueError, match="rank 2"):
        agg.add(ids[None], probs)
    with pytest.raises(ValueError, match="integers"):
        agg.add(ids.astype(np.float32), probs)
    with pytest.raises(ValueError, match="unknown aggregator"):
        fusion.MeshAggregator(P, C, "max", device="cpu")
    assert fusion.MeshAggregator(P, C, "SUM", device="cpu").aggregator == "sum"
