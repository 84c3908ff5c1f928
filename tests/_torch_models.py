"""Tolerances between the JAX package's segmentation models and the port's
on the CPU, shared by tests/test_torch_models*.py.

Tolerances between the frameworks come from bf16: both round the same
convolutions to bf16, but their float32 GroupNorm statistics differ by
~1e-4 (XLA's are the less exact: 1.3e-4 from a float64 reference where
PyTorch's are 2e-6), and a float32 difference that moves an activation
across a bf16 rounding boundary changes it by 2^-8 relative, which the
next layers carry on. Over four seeds at these narrow widths, flax's own
init gave max |dlogit| / max |logit| <= 0.022, max |dprob| <= 0.012, mean
|dprob| <= 1.2e-3 and >= 99% equal argmax; with biases and GroupNorm
scales perturbed by N(0, 0.1) (as the model test does, so every leaf's
conversion shows) up to 0.057, 0.040, 3.0e-3 and >= 97%. The bounds
below hold about 1.5x over the latter; a wrong leaf mapping gives O(1)
errors, and the conversion itself is checked leaf by leaf, exactly.
"""

import numpy as np

PROB_ATOL = 0.06  # max |dprob| between the frameworks
PROB_MEAN = 5e-3  # mean |dprob|
ARGMAX_SHARE = 0.95  # share of pixels with the same argmax
LOGIT_RTOL = 0.08  # max |dlogit| / max |logit|


def assert_probs_close(got, want):
    """(..., C) probabilities of the two frameworks within the bounds."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert err.max() <= PROB_ATOL, err.max()
    assert err.mean() <= PROB_MEAN, err.mean()
    same = (got.argmax(-1) == want.argmax(-1)).mean()
    assert same >= ARGMAX_SHARE, same
