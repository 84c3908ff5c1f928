"""semantic_meshes_torch.ops.segment_sum against a float64 oracle and the
JAX package's segment_sum at its default method, on the CPU.

Mirrors tests/test_ops.py's oracle cases: the P sweep, out-of-range rows,
heavy segments, counts beyond 2^16 rows in one segment, more than 64
heavy segments, negative and large scales, all zero, one huge segment,
rank-1 data. The JAX package's method names of f32 class (None,
"exact16", "float32", "mxu") all take the port's one route, so each gives
the same bits; "bfloat16", its lossy scatter, is refused. The limb-width
ablation of test_ops.py tests exact16's int16 limbs, which the port does
not have, and has no counterpart.

Tolerance: the port adds each segment's rows in order in float32, so a
segment of n rows is within n * 2^-24 * sum |x| of the exact sum (the
bound of recursive summation; BOUND_SLACK covers float64 rounding of the
bound itself). Against JAX both sides carry such an error, so the bound
doubles there.
"""

import numpy as np
import pytest
import torch

from semantic_meshes import ops as jops
from semantic_meshes_torch import ops

BOUND_SLACK = 1e-6
METHODS = [None, "exact16", "float32", "mxu"]


def _oracle(data, idx, P):
    """(sum, bound) in float64: each segment's sum of its in-range rows,
    and n * 2^-24 * sum |x| of them."""
    data = np.asarray(data, np.float64).reshape(len(idx), -1)
    keep = (idx >= 0) & (idx < P)
    out = np.zeros((P, data.shape[1]))
    mag = np.zeros((P, data.shape[1]))
    np.add.at(out, idx[keep], data[keep])
    np.add.at(mag, idx[keep], np.abs(data[keep]))
    n = np.bincount(idx[keep], minlength=P)[:, None]
    return out, n * 2.0 ** -24 * mag + BOUND_SLACK


def _check(data, idx, P, method=None, jax=True):
    """The port against the oracle within its bound, against JAX's default
    within twice it, and every method name equal bit for bit."""
    got = ops.segment_sum(torch.from_numpy(data), torch.from_numpy(idx), P,
                          method=method)
    squeeze = data.ndim == 1
    assert tuple(got.shape) == ((P,) if squeeze else (P, data.shape[1]))
    got = got.numpy().reshape(P, -1)
    want, bound = _oracle(data, idx, P)
    assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()
    if jax:
        j = np.asarray(jops.segment_sum(data, idx, P)).reshape(P, -1)
        assert (np.abs(got - j) <= 2 * bound).all(), np.abs(got - j).max()
    for other in METHODS:
        again = ops.segment_sum(torch.from_numpy(data),
                                torch.from_numpy(idx), P, method=other)
        np.testing.assert_array_equal(again.numpy().reshape(P, -1), got)
    return got


@pytest.mark.parametrize("P", [7, 129, 2048, 3082, 5000])
def test_p_sweep_matches_oracle_and_jax(P):
    """test_ops.py's mxu sweep (7, 129, 2048) and its scatter case past
    SEGMENT_MXU_MAX_P, with out-of-range rows on both ends."""
    rng = np.random.default_rng(P)
    N, D = 5000, 6
    data = rng.normal(size=(N, D)).astype(np.float32)
    idx = rng.integers(-3, P + 5, size=N).astype(np.int32)
    _check(data, idx, P)


def test_random_rows_int64_ids():
    rng = np.random.default_rng(10)
    N, D, P = 20_000, 5, 5000
    data = rng.normal(size=(N, D)).astype(np.float32) * 3.7
    idx = rng.integers(-2, P + 3, size=N).astype(np.int64)
    _check(data, idx, P)


def test_heavy_segment():
    rng = np.random.default_rng(11)
    N, D, P = 40_000, 3, 4000
    data = rng.random((N, D)).astype(np.float32)
    idx = np.where(rng.random(N) < 0.9, 7,
                   rng.integers(0, P, size=N)).astype(np.int32)
    _check(data, idx, P)


def test_count_beyond_2_16_in_one_segment():
    rng = np.random.default_rng(12)
    N, D, P = 140_000, 2, 4000
    data = rng.random((N, D)).astype(np.float32)
    idx = np.where(rng.random(N) < 0.5, 3,
                   rng.integers(0, P, size=N)).astype(np.int32)
    assert (idx == 3).sum() > 2 ** 16
    _check(data, idx, P)


def test_more_than_64_heavy_segments():
    rng = np.random.default_rng(16)
    heavy, per, P = 70, 16_500, 4000
    idx = np.repeat(np.arange(heavy, dtype=np.int32), per)
    data = -(0.9 + 0.1 * rng.random((heavy * per, 2))).astype(np.float32)
    _check(data, idx, P)


def test_negative_and_large_scale():
    rng = np.random.default_rng(13)
    N, D, P = 8000, 4, 4000
    data = (rng.normal(size=(N, D)) * 1e6).astype(np.float32)
    idx = rng.integers(0, P, size=N).astype(np.int32)
    _check(data, idx, P)


@pytest.mark.parametrize("P", [100, 4000])
def test_all_zero(P):
    idx = np.arange(100, dtype=np.int32) % P
    data = np.zeros((100, 3), np.float32)
    assert not _check(data, idx, P).any()


def test_single_huge_segment_all_rows():
    rng = np.random.default_rng(14)
    N, P = 100_000, 4000
    data = rng.random((N, 2)).astype(np.float32)
    _check(data, np.zeros(N, np.int32), P)


def test_rank1_data():
    rng = np.random.default_rng(3)
    data = rng.normal(size=500).astype(np.float32)
    idx = rng.integers(0, 17, size=500).astype(np.int32)
    _check(data, idx, 17)


def test_bfloat16_is_refused():
    data, idx = torch.ones(4, 2), torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="lossy"):
        ops.segment_sum(data, idx, 3, method="bfloat16")
    with pytest.raises(ValueError, match="unknown segment_sum method"):
        ops.segment_sum(data, idx, 3, method="float16")
