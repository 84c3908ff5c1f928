"""Segmentation metrics of semantic_meshes_torch against the JAX package's
on the same seeded labels and probabilities, on the CPU.

Mirrors tests/test_metrics.py (its oracles unchanged). Tolerances: the
confusion matrices are compared exactly (each frame's counts are exact
in float32; the sum into the matrix rounds past 2^24 per cell on both
sides, the same way); the scalar results (Accuracy, MeanIoU) at rtol
1e-6, because their class reductions may add in another order.
"""

import numpy as np
import pytest
import torch

from semantic_meshes import metrics as jmetrics
from semantic_meshes_torch import metrics

CPU = "cpu"


def _oh(labels, C):
    labels = np.asarray(labels)
    out = np.zeros(labels.shape + (C,), np.float32)
    valid = labels >= 0
    idx = np.nonzero(valid)
    out[idx + (labels[valid],)] = 1.0
    return out


def _pair(cls, C, mode="error"):
    """The port's metric (on the CPU) and the JAX package's."""
    return cls(C, mode, device=CPU), getattr(jmetrics, cls.__name__)(C, mode)


def _same(m, jm):
    np.testing.assert_array_equal(m.full_matrix.numpy(),
                                  np.asarray(jm.full_matrix))
    np.testing.assert_allclose(np.asarray(m.result()),
                               np.asarray(jm.result()), rtol=1e-6, atol=0)


class TestConfusionMatrix:
    def test_basic_counts(self):
        C = 4
        gt = np.array([[0, 1], [2, 3]])
        pred = np.array([[0, 2], [2, 3]])
        m, jm = _pair(metrics.ConfusionMatrix, C)
        for x in (m, jm):
            x.update_state(_oh(gt, C), _oh(pred, C))
        cm = m.result().numpy()
        expect = np.zeros((C, C))
        for g, p in zip(gt.ravel(), pred.ravel()):
            expect[g, p] += 1
        np.testing.assert_array_equal(cm, expect)
        assert m.result().dtype == torch.float32
        _same(m, jm)

    def test_gt_dont_care_ignored(self):
        C = 3
        gt = np.array([0, -1, 2])
        pred = np.array([0, 1, 2])
        m = metrics.ConfusionMatrix(C, device=CPU)
        m.update_state(_oh(gt, C), _oh(pred, C))
        assert float(m.result().sum()) == 2

    def test_pred_dont_care_error_mode(self):
        C = 3
        gt = np.array([0, 1])
        pred_probs = _oh(np.array([0, 1]), C)
        pred_probs[1] = 0.0  # predicted nothing
        m = metrics.Accuracy(C, dontcare_prediction="error", device=CPU)
        m.update_state(_oh(gt, C), pred_probs)
        assert abs(float(m.result()) - 0.5) < 1e-6
        assert float(m.full_matrix[1, C]) == 1  # the don't-care bucket

    def test_pred_dont_care_forbidden_mode(self):
        C = 3
        gt = np.array([0, 1])
        pred_probs = _oh(np.array([0, 1]), C)
        pred_probs[1] = 0.0  # argmax -> class 0 under "forbidden"
        m = metrics.Accuracy(C, dontcare_prediction="forbidden", device=CPU)
        m.update_state(_oh(gt, C), pred_probs)
        assert abs(float(m.result()) - 0.5) < 1e-6  # class 0 != gt 1

    def test_invalid_mode_raises(self):
        with pytest.raises(ValueError):
            metrics.Accuracy(3, dontcare_prediction="nope", device=CPU)

    def test_default_device_is_the_card(self):
        if torch.cuda.is_available():
            assert metrics.MeanIoU(3).full_matrix.is_cuda
            return
        with pytest.raises(RuntimeError, match="is_available"):
            metrics.MeanIoU(3)


class TestAccuracyMeanIoU:
    def test_streaming_equals_batch(self):
        rng = np.random.default_rng(0)
        C = 5
        gt = rng.integers(0, C, 400)
        pred = np.where(rng.random(400) < 0.7, gt, rng.integers(0, C, 400))
        m1 = metrics.Accuracy(C, device=CPU)
        m1.update_state(_oh(gt, C), _oh(pred, C))
        m2, jm2 = _pair(metrics.Accuracy, C)
        for i in range(0, 400, 100):
            for x in (m2, jm2):
                x.update_state(_oh(gt[i:i+100], C), _oh(pred[i:i+100], C))
        np.testing.assert_allclose(
            float(m1.result()), float(m2.result()), atol=1e-6
        )
        np.testing.assert_allclose(float(m1.result()), np.mean(gt == pred),
                                   atol=1e-6)
        _same(m2, jm2)

    def test_mean_iou_oracle(self):
        C = 3
        gt = np.array([0, 0, 1, 1, 2, 2])
        pred = np.array([0, 1, 1, 1, 2, 0])
        m, jm = _pair(metrics.MeanIoU, C)
        for x in (m, jm):
            x.update_state(_oh(gt, C), _oh(pred, C))
        # class0: tp=1 fn=1 fp=1 -> 1/3; class1: tp=2 fn=0 fp=1 -> 2/3;
        # class2: tp=1 fn=1 fp=0 -> 1/2
        expect = (1 / 3 + 2 / 3 + 1 / 2) / 3
        np.testing.assert_allclose(float(m.result()), expect, atol=1e-6)
        _same(m, jm)

    def test_absent_class_excluded(self):
        C = 4  # class 3 never appears in gt
        gt = np.array([0, 1, 2])
        pred = np.array([0, 1, 2])
        m = metrics.MeanIoU(C, device=CPU)
        m.update_state(_oh(gt, C), _oh(pred, C))
        np.testing.assert_allclose(float(m.result()), 1.0, atol=1e-6)

    def test_empty_results_are_zero(self):
        for cls in (metrics.Accuracy, metrics.MeanIoU):
            m, jm = _pair(cls, 4)
            assert float(m.result()) == float(jm.result()) == 0.0

    def test_merge(self):
        rng = np.random.default_rng(1)
        C = 4
        gt = rng.integers(0, C, 200)
        pred = rng.integers(0, C, 200)
        whole = metrics.ConfusionMatrix(C, device=CPU)
        whole.update_state(_oh(gt, C), _oh(pred, C))
        a = metrics.ConfusionMatrix(C, device=CPU)
        b = metrics.ConfusionMatrix(C, device=CPU)
        a.update_state(_oh(gt[:100], C), _oh(pred[:100], C))
        b.update_state(_oh(gt[100:], C), _oh(pred[100:], C))
        a.merge(b)
        assert torch.equal(a.result(), whole.result())


def test_one_hot_with_ignore():
    oh = metrics.one_hot_with_ignore(np.array([1, -1, 0]), 3, device=CPU)
    assert oh.dtype == torch.float32
    np.testing.assert_array_equal(
        oh.numpy(), [[0, 1, 0], [0, 0, 0], [1, 0, 0]]
    )
    np.testing.assert_array_equal(
        oh.numpy(),
        np.asarray(jmetrics.one_hot_with_ignore(np.array([1, -1, 0]), 3)))


def test_colorize_classes():
    pal = np.array([[255, 0, 0], [0, 255, 0]], np.uint8)
    img = metrics.colorize_classes(
        torch.tensor([[0, 1]]), pal, dont_care_mask=np.array([[False, True]])
    )
    np.testing.assert_array_equal(img, [[[255, 0, 0], [0, 0, 0]]])


def test_update_state_labels_matches_probs():
    rng = np.random.default_rng(7)
    C = 5
    gt = rng.integers(-1, C, 300)
    pred = rng.random((300, C)).astype(np.float32)
    pred[rng.random(300) < 0.1] = 0.0  # some pred don't-cares
    for mode in ("error", "forbidden"):
        m1 = metrics.ConfusionMatrix(C, mode, device=CPU)
        m1.update_state(_oh(gt, C), pred)
        m2, jm2 = _pair(metrics.ConfusionMatrix, C, mode)
        m2.update_state_labels(gt, pred)
        jm2.update_state_labels(gt, pred)
        assert torch.equal(m1.full_matrix, m2.full_matrix)
        _same(m2, jm2)


@pytest.mark.parametrize("mode", ["error", "forbidden"])
def test_seeded_frames_equal_jax(mode):
    """Several frames of a 40-class label image with ignored pixels,
    don't-care predictions and labels past the last class (dropped by
    both): every metric's matrix equals the JAX package's bit for bit."""
    rng = np.random.default_rng(3)
    C, H, W = 40, 23, 31
    group = [_pair(cls, C, mode) for cls in (
        metrics.Accuracy, metrics.MeanIoU, metrics.ConfusionMatrix)]
    for _ in range(3):
        gt = rng.integers(-1, C + 2, (H, W)).astype(np.int32)
        pred = rng.random((H, W, C)).astype(np.float32)
        pred /= pred.sum(-1, keepdims=True)
        pred[rng.random((H, W)) < 0.1] = 0.0
        for m, jm in group:
            m.update_state_labels(gt, pred)
            jm.update_state_labels(gt, pred)
    for m, jm in group:
        _same(m, jm)
    assert float(group[2][0].full_matrix.sum()) > 0


def test_argmax_ties_and_nan_pick_the_first_as_jax():
    """A tie goes to the first maximal class, a NaN counts as the maximum
    (the first NaN): torch.argmax and jnp.argmax agree."""
    C = 4
    pred = np.array([
        [0.4, 0.4, 0.2, 0.0],           # tie: class 0
        [0.1, 0.3, 0.3, 0.3],           # three-way tie: class 1
        [0.2, np.nan, 0.5, np.nan],     # NaN: the first NaN, class 1
        [np.nan, 0.2, 0.3, 0.4],        # NaN first: class 0
    ], np.float32)
    gt = np.array([2, 2, 2, 2])
    for mode in ("error", "forbidden"):
        m, jm = _pair(metrics.ConfusionMatrix, C, mode)
        m.update_state_labels(gt, pred)
        jm.update_state_labels(gt, pred)
        _same(m, jm)
    got = m.full_matrix.numpy()[2]
    np.testing.assert_array_equal(got, [2, 2, 0, 0, 0])


def test_counts_past_two_to_the_24_round_as_jax():
    """The matrix is float32, as the JAX package's: a cell already at 2^24
    stays there when one more pixel lands in it (the sum rounds to even),
    and reaches 2^24 + 2 after two more in one frame. The port keeps the
    reference's rounding (ROADMAP: a known fault of the reference)."""
    C = 3
    big = np.float32(2 ** 24)
    m, jm = _pair(metrics.ConfusionMatrix, C)
    cm0 = np.zeros((C, C + 1), np.float32)
    cm0[1, 1] = big
    cm0[2, 0] = big + 2
    m._cm = torch.from_numpy(cm0.copy())
    import jax.numpy as jnp

    jm._cm = jnp.asarray(cm0)
    one = _oh(np.array([1]), C)
    for x in (m, jm):
        x.update_state(one, one)  # one pixel into (1, 1)
    assert float(m.full_matrix[1, 1]) == float(big)  # rounded away
    two = _oh(np.array([2, 2]), C)
    for x in (m, jm):
        x.update_state(two, _oh(np.array([0, 0]), C))  # +2 into (2, 0)
    assert float(m.full_matrix[2, 0]) == float(big) + 4
    _same(m, jm)
