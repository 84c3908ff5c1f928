"""Fusion's CUDA kernels (csrc/fusion.cu, wrapper fusion_kernel.py) against
the plain chain of PyTorch ops they replace (fusion._segment_sums_plain and
_mix), on the same card tensors. Every test here is marked `gpu` and
decides inside itself whether a CUDA card is present; without one it
skips. Run on the card with

    python -m pytest -m gpu tests/test_torch_fusion_kernel.py

A primitive whose pixels lie inside one chunk of sorted positions is
summed in the plain chain's order, so its row is bit-equal to the plain
chain's; a primitive whose run crosses a chunk edge is summed chunk by
chunk and meets test_torch_fusion.py's tolerance (rtol 1e-5, atol 1e-6).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from semantic_meshes_torch import (distributed, fusion, fusion_kernel, render,
                                   testing)
from semantic_meshes_torch.data import stack_cameras

pytestmark = pytest.mark.gpu

RTOL, ATOL = 1e-5, 1e-6
P, W, H = 400, 96, 80
IEW = 0.5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90a): the kernels have no CPU "
                    "mode; the plain chain is tested on the CPU")
    return torch.device("cuda", 0)


def _view(seed, classes, p=P, width=W, height=H):
    """(W, H) uint32 ids, as the renderers return them, with background,
    ids equal to and above P and ids that read negative; a block of one id
    longer than 4 chunks; (W, H, C) probs with don't-care pixels; (W, H)
    weights, some 0."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, p, size=(width, height)).astype(np.uint32)
    ids[rng.random((width, height)) < 0.2] = 0xFFFFFFFF  # background
    ids[rng.random((width, height)) < 0.03] = p  # the key of dropped pixels
    ids[rng.random((width, height)) < 0.03] = p + 7
    ids[rng.random((width, height)) < 0.02] = 0x80000001  # negative as int32
    ids[10:50, 20:50] = 7  # 1200 pixels, with id 7's scattered ones
    logits = rng.normal(size=(width, height, classes)) * 2.0
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    dont_care = rng.random((width, height)) < 0.15
    probs[dont_care] *= 0.3  # class sum 0.3 <= 0.5
    probs[rng.random((width, height)) < 0.02] = 0.0  # log(0) for mul
    weights = rng.uniform(0.2, 2.0, size=(width, height))
    weights[rng.random((width, height)) < 0.05] = 0.0
    return ids, probs.astype(np.float32), weights.astype(np.float32)


def _on_card(ids, probs, weights, device):
    """The (H, W) views of the (W, H) inputs that MeshAggregator.add fuses:
    transposed, so every read is strided."""
    prim = fusion.as_ids(ids, device).t()
    pr = torch.from_numpy(probs).to(device).transpose(0, 1)
    w = None if weights is None else torch.from_numpy(weights).to(
        device).t()
    return prim, pr, w


def _compare(got, want, exact):
    """Rows inside one chunk (testing.inside_one_chunk: those of
    primitives without pixels too) bit-equal; rows that cross a chunk edge
    within the stated tolerance."""
    assert torch.equal(got[exact].view(torch.int32),
                       want[exact].view(torch.int32))
    np.testing.assert_allclose(got[~exact].cpu().numpy(),
                               want[~exact].cpu().numpy(), rtol=RTOL,
                               atol=ATOL)


def _plain(prim, probs, weights, aggregator, raw=False, p=P):
    seg = fusion._segment_sums_plain(prim, probs, weights, num_primitives=p,
                                     aggregator=aggregator)
    return seg if raw else fusion._mix(seg, IEW)


def _kernels(prim, probs, weights, aggregator, raw=False, p=P):
    return fusion_kernel.segment_sums(prim, probs, weights, IEW,
                                      num_primitives=p,
                                      aggregator=aggregator, raw=raw)


@pytest.mark.parametrize("classes", [1, 19, 32, 33, 40, 100, 300])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("aggregator", ["sum", "summax", "mul"])
def test_kernels_match_the_plain_chain(cuda, aggregator, weighted, classes):
    ids, probs, weights = _view(classes, classes)
    prim, pr, w = _on_card(ids, probs, weights if weighted else None, cuda)
    exact = testing.inside_one_chunk(prim, P)
    assert exact.any() and (~exact).any()
    launches = fusion_kernel.launches
    got = _kernels(prim, pr, w, aggregator)
    assert fusion_kernel.launches == launches + 3
    _compare(got, _plain(prim, pr, w, aggregator), exact)


@pytest.mark.parametrize("aggregator", ["sum", "summax", "mul"])
def test_raw_sums_and_counts_for_the_sharded_fuse(cuda, aggregator):
    ids, probs, weights = _view(5, 40)
    prim, pr, w = _on_card(ids, probs, weights, cuda)
    exact = testing.inside_one_chunk(prim, P)
    got = _kernels(prim, pr, w, aggregator, raw=True)
    want = _plain(prim, pr, w, aggregator, raw=True)
    assert got.shape == (P, 41)
    assert torch.equal(got[:, 40], want[:, 40])  # the counts, exactly
    _compare(got, want, exact)
    # the sharded path's mix over the raw sums is the kernels' own mix
    direct = _kernels(prim, pr, w, aggregator)
    assert torch.equal(fusion._mix(got, IEW), direct)


@pytest.mark.parametrize("aggregator", ["sum", "summax", "mul"])
def test_an_all_background_frame(cuda, aggregator):
    ids, probs, weights = _view(6, 19)
    ids[:] = 0xFFFFFFFF
    prim, pr, w = _on_card(ids, probs, weights, cuda)
    got = _kernels(prim, pr, w, aggregator)
    assert torch.equal(got.view(torch.int32),
                       _plain(prim, pr, w, aggregator).view(torch.int32))


def test_long_runs_and_contiguous_int64_ids(cuda):
    """One primitive over 4000 pixels, split over many chunks; ids as
    contiguous int64 (H, W)."""
    ids, probs, weights = _view(7, 40, p=8, width=200, height=100)
    prim, pr, w = _on_card(ids, probs, weights, cuda)
    prim = prim.contiguous().to(torch.int64)
    prim[:40, :100] = 3
    exact = testing.inside_one_chunk(prim, 8)
    assert not exact[3]
    for aggregator in ("sum", "mul"):
        _compare(_kernels(prim, pr, w, aggregator, p=8),
                 _plain(prim, pr, w, aggregator, p=8), exact)


def _exact(prim, probs, weights, aggregator, p):
    """The mixed rows from the plain chain's float32 pixel values, summed
    in float64: what both summation orders round. Over a run of 10^5
    pixels the plain chain's one sequential float32 sum drifts past rtol
    1e-5 from it."""
    flat = prim.reshape(-1).to(torch.int64)
    n, c = flat.numel(), probs.shape[-1]
    in_range = (flat >= 0) & (flat < p)
    probs_flat = probs.reshape(n, c)
    pixel_w = (torch.ones(n, device=probs.device) if weights is None
               else weights.reshape(n))
    base_w = torch.where(in_range & (probs_flat.sum(-1) > 0.5), pixel_w,
                         torch.zeros_like(pixel_w))
    values = fusion._pixel_values(probs_flat, base_w, aggregator).double()
    sums = torch.zeros((p, c), dtype=torch.float64, device=probs.device)
    sums.index_add_(0, flat[in_range], values[in_range])
    counts = torch.zeros(p, dtype=torch.float64, device=probs.device)
    counts.index_add_(0, flat[in_range],
                      torch.ones_like(counts[:1]).expand(int(in_range.sum())))
    mix = IEW / counts.clamp(min=1.0) + (1.0 - IEW)
    return mix[:, None] * sums


def test_the_same_call_twice_is_bit_identical(cuda):
    """At ScanNet's frame size and 40 classes, with a run of 120000
    pixels: twice bit-identical; rows inside one chunk bit-equal to the
    plain chain, the others within rtol 1e-5 of the exact sum."""
    rng = np.random.default_rng(8)
    ids = rng.integers(-5, 5000, size=(968, 1296)).astype(np.int32)
    ids[:300, :400] = 17  # a wall triangle beside the sensor
    prim = torch.from_numpy(ids).to(cuda)
    probs = torch.softmax(torch.randn((968, 1296, 40), device=cuda,
                                      generator=torch.Generator(
                                          device=cuda).manual_seed(0)), -1)
    exact = testing.inside_one_chunk(prim, 5000)
    assert not exact[17]
    for aggregator in ("sum", "summax", "mul"):
        a = _kernels(prim, probs, None, aggregator, p=5000)
        b = _kernels(prim, probs, None, aggregator, p=5000)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        want = _plain(prim, probs, None, aggregator, p=5000)
        assert torch.equal(a[exact].view(torch.int32),
                           want[exact].view(torch.int32))
        np.testing.assert_allclose(
            a[~exact].double().cpu().numpy(),
            _exact(prim, probs, None, aggregator, 5000)[~exact].cpu().numpy(),
            rtol=RTOL, atol=ATOL)


def test_the_card_paths_agree_bit_for_bit(cuda):
    """MeshAggregator.add, add_many and distributed.fuse_views give the
    same accumulator on the card, through the kernels."""
    v, f = testing.make_cube(6)
    cams = testing.make_ring_cameras(3, 256, 192)
    rot, trans, fl, pp = stack_cameras(cams)
    gen = torch.Generator(device=cuda).manual_seed(1)
    probs = torch.softmax(torch.randn((3, 192, 256, 19), device=cuda,
                                      generator=gen), -1)
    renderer = render.TrianglesRenderer(SimpleNamespace(vertices=v, faces=f),
                                        device=cuda)
    ids = [renderer.render(cam)[0] for cam in cams]
    probs_whc = probs.transpose(1, 2)
    fusion_kernel.launches = fusion_kernel.views = 0
    one = fusion.MeshAggregator(len(f), 19, "mul", IEW, device=cuda)
    for k in range(3):
        one.add(ids[k], probs_whc[k])
    many = fusion.MeshAggregator(len(f), 19, "mul", IEW, device=cuda)
    many.add_many(ids, probs_whc)
    acc, ov = distributed.fuse_views(v, f, rot, trans, fl, pp, probs, IEW,
                                     num_primitives=len(f), aggregator="mul",
                                     height=192, width=256, device=cuda)
    assert int(ov) == 0
    assert fusion_kernel.views == 9 and fusion_kernel.launches == 27
    assert torch.equal(one.state, many.state)
    assert torch.equal(one.state, acc)
