"""Deterministic segment sum.

Counterpart of `semantic_meshes/ops.py::segment_sum`. The JAX package
picks one of three TPU routes (one-hot MXU matmul, f32 scatter, int16-limb
`exact16` scatter), each a workaround for the TPU's slow scatter. On the
GPU one formulation serves every segment count: a stable sort of the rows
by segment, then a segmented sum over the sorted rows
(`torch.segment_reduce`, which adds each segment's rows in order). No
floating-point atomics are involved, so the same inputs give a
bit-identical result from run to run, which is the fusion contract
(`semantic_meshes/fusion.py`: race-free, deterministic reductions).
"""

from __future__ import annotations

import torch

# the JAX package's f32-class methods (semantic_meshes/ops.py:314-362); all
# of them take the one route here
METHODS = (None, "exact16", "float32", "mxu")


def segment_sum(data, idx, num_segments, method=None):
    """Sum rows of `data` (N, D) f32 (or (N,)) into `num_segments` segments
    by `idx` (N,) integer; rows with an index outside [0, num_segments)
    are dropped. Returns (num_segments, D) (or (num_segments,)).

    method: one of the JAX package's f32-class names (METHODS), each the
    same deterministic route; "bfloat16", its lossy scatter, is refused.
    Dropped rows sort after every segment and lie past the last offset,
    so the segmented sum never reads them.
    """
    if method == "bfloat16":
        raise ValueError(
            "segment_sum method 'bfloat16' is the JAX package's lossy "
            "scatter (bf16 values, ~0.8% error); the port sums in float32 "
            "only: pass None, 'exact16', 'float32' or 'mxu'")
    if method not in METHODS:
        raise ValueError(f"unknown segment_sum method {method!r}; expected "
                         f"one of {METHODS}")
    squeeze = data.ndim == 1
    if squeeze:
        data = data[:, None]
    idx = idx.to(torch.int64)
    P = int(num_segments)
    valid = (idx >= 0) & (idx < P)
    key = torch.where(valid, idx, P)
    order = torch.sort(key, stable=True).indices
    counts = torch.bincount(key, minlength=P + 1)[:P]
    offsets = torch.zeros(P + 1, dtype=torch.int64, device=data.device)
    torch.cumsum(counts, dim=0, out=offsets[1:])
    out = torch.segment_reduce(
        data[order], "sum", offsets=offsets, axis=0, unsafe=True
    )
    return out[:, 0] if squeeze else out
