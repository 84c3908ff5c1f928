"""Fusion of one view on the card: CUDA wrapper of csrc/fusion.cu.

The per-primitive segment sums of one view (fusion._accumulate_view) in
three hand-written kernels and one `torch.sort`, where the plain chain of
PyTorch ops (fusion._segment_sums_plain) takes ~63 launches and two host
waits:

1. `fusion_keys_kernel`: int32 keys of the id image, read by its strides in
   row-major (H, W) order (the id where 0 <= id < P, else P), and the
   output filled with what a primitive without pixels reads;
2. `torch.sort(stable=True)` of the keys: the pixel order, dropped pixels
   last;
3. `fusion_rows_kernel`: one warp a chunk of sorted positions, each pixel's
   probability row read once, the run sums in sorted order, the rows of
   runs inside a chunk written with the weight mix;
4. `fusion_carry_kernel`: the rows of runs that cross chunk edges, their
   partials added in chunk order.

Nothing is uploaded and nothing syncs with the host. The result is
bit-identical from run to run, and bit-identical to the plain chain on the
card for every primitive whose pixels lie inside one chunk of sorted
positions (tests/test_torch_fusion_kernel.py); the plain chain stays the
CPU implementation. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

# kernel launches of this module and views it fused (a caller that counts
# sets them to 0 first); the plain chain counts neither
launches = 0
views = 0

_AGGREGATOR_CODES = {"sum": 0, "summax": 1, "mul": 2}


class _Params(ctypes.Structure):
    """csrc/fusion.cu's `Params`, field for field."""

    _fields_ = [
        ("ids", ctypes.c_void_p),
        ("ids_s0", ctypes.c_longlong),
        ("ids_s1", ctypes.c_longlong),
        ("probs", ctypes.c_void_p),
        ("probs_s0", ctypes.c_longlong),
        ("probs_s1", ctypes.c_longlong),
        ("probs_s2", ctypes.c_longlong),
        ("weights", ctypes.c_void_p),
        ("weights_s0", ctypes.c_longlong),
        ("weights_s1", ctypes.c_longlong),
        ("keys", ctypes.c_void_p),
        ("sorted_keys", ctypes.c_void_p),
        ("order", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("carry", ctypes.c_void_p),
        ("carry_count", ctypes.c_void_p),
        ("out_size", ctypes.c_longlong),
        ("fill", ctypes.c_float),
        ("iew", ctypes.c_float),
        ("one_minus_iew", ctypes.c_float),
        ("height", ctypes.c_int),
        ("width", ctypes.c_int),
        ("classes", ctypes.c_int),
        ("primitives", ctypes.c_int),
        ("chunks", ctypes.c_int),
        ("raw", ctypes.c_int),
        ("ids64", ctypes.c_int),
    ]


_fns = None


def _kernels():
    """(positions a chunk, (keys, rows, carry) C entry points) of the
    fusion library (built at first use); each entry point returns
    cudaGetLastError() after its launch."""
    global _fns
    if _fns is None:
        from . import _build

        lib = _build.load("fusion")
        keys_fn, rows_fn, carry_fn = (lib.sm_fusion_keys, lib.sm_fusion_rows,
                                      lib.sm_fusion_carry)
        keys_fn.argtypes = carry_fn.argtypes = (ctypes.POINTER(_Params),
                                                ctypes.c_void_p)
        rows_fn.argtypes = (ctypes.POINTER(_Params), ctypes.c_int,
                            ctypes.c_void_p)
        for fn in (keys_fn, rows_fn, carry_fn):
            fn.restype = ctypes.c_int
        _fns = (lib.sm_fusion_chunk(), (keys_fn, rows_fn, carry_fn))
    return _fns


def _launch(fn, name, *args):
    global launches
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launches += 1


def _mix_scalars(images_equal_weight):
    """(iew, 1 - iew, what a primitive without pixels reads), each rounded
    to float32 as the plain chain's tensor arithmetic rounds them: its mix
    at one pixel times its +0.0 sum."""
    iew = np.float32(images_equal_weight)
    rest = np.float32(1.0 - images_equal_weight)
    with np.errstate(all="ignore"):
        fill = np.float32(0.0) * (iew / np.float32(1.0) + rest)
    return float(iew), float(rest), float(fill)


def segment_sums(prim, probs, weights, images_equal_weight, *,
                 num_primitives, aggregator, raw=False):
    """One view's fusion on the card.

    prim: integer ids (H, W); probs: float32 (H, W, C); weights: float32
    (H, W) or None; all CUDA tensors on one card, in any strides. Returns
    (P, C) float32, each row the primitive's mixed contribution (the
    plain chain's mix[:, None] * S), or with raw (P, C + 1): the sums S
    and, in column C, the count of the primitive's pixels, which a sharded
    fuse adds over its ranks before the mix."""
    global views
    if aggregator not in _AGGREGATOR_CODES:
        raise ValueError(f"unknown aggregator {aggregator!r}")
    device = probs.device
    for name, t in (("primitive ids", prim), ("probs", probs),
                    ("weights", weights)):
        if t is not None and (not t.is_cuda or t.device != device):
            raise ValueError(f"{name} must be a CUDA tensor on {device}, "
                             f"got {t.device}")
    if probs.dtype != torch.float32 or (
            weights is not None and weights.dtype != torch.float32):
        raise ValueError("probs and weights must be float32")
    if prim.dtype not in (torch.int32, torch.int64):
        if prim.dtype.is_floating_point or prim.dtype == torch.bool:
            raise ValueError(f"primitive ids must be integers, got "
                             f"{prim.dtype}")
        prim = prim.to(torch.int32)
    if prim.ndim != 2 or probs.shape[:-1] != prim.shape or (
            weights is not None and weights.shape != prim.shape):
        raise ValueError(f"ids {tuple(prim.shape)}, probs "
                         f"{tuple(probs.shape)} and weights "
                         f"{None if weights is None else tuple(weights.shape)}"
                         " must share their (H, W) pixels")
    P, C = int(num_primitives), int(probs.shape[-1])
    pixels = prim.numel()
    if not 0 <= P < 2**31 - 1 or C < 1 or pixels >= 2**31:
        raise ValueError(f"fusion kernels take 0 <= P < 2^31 - 1, C >= 1 and "
                         f"fewer than 2^31 pixels, got P={P}, C={C}, "
                         f"{pixels} pixels")
    iew, rest, fill = _mix_scalars(images_equal_weight)
    out = torch.empty((P, C + 1) if raw else (P, C), dtype=torch.float32,
                      device=device)
    if pixels == 0 or P == 0:
        return out.fill_(0.0 if raw else fill)
    chunk, (keys_fn, rows_fn, carry_fn) = _kernels()
    chunks = -(-pixels // chunk)
    height, width = prim.shape
    keys = torch.empty(pixels, dtype=torch.int32, device=device)
    carry = torch.empty((chunks, 2, C), dtype=torch.float32, device=device)
    carry_count = torch.empty((chunks, 2), dtype=torch.int32, device=device)
    p = _Params()
    p.ids, (p.ids_s0, p.ids_s1) = prim.data_ptr(), prim.stride()
    p.probs = probs.data_ptr()
    p.probs_s0, p.probs_s1, p.probs_s2 = probs.stride()
    if weights is not None:
        p.weights = weights.data_ptr()
        p.weights_s0, p.weights_s1 = weights.stride()
    p.keys, p.out = keys.data_ptr(), out.data_ptr()
    p.carry, p.carry_count = carry.data_ptr(), carry_count.data_ptr()
    p.out_size = out.numel()
    p.fill = 0.0 if raw else fill
    p.iew, p.one_minus_iew = iew, rest
    p.height, p.width, p.classes, p.primitives = height, width, C, P
    p.chunks, p.raw = chunks, int(raw)
    p.ids64 = int(prim.dtype == torch.int64)
    with torch.cuda.device(device):
        _launch(keys_fn, "fusion_keys", ctypes.byref(p))
        sorted_keys, order = torch.sort(keys, stable=True)
        p.sorted_keys, p.order = sorted_keys.data_ptr(), order.data_ptr()
        _launch(rows_fn, "fusion_rows", ctypes.byref(p),
                _AGGREGATOR_CODES[aggregator])
        _launch(carry_fn, "fusion_carry", ctypes.byref(p))
    views += 1
    return out

