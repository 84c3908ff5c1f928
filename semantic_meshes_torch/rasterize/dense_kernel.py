"""Dense streaming z-resolve: plain PyTorch version and CUDA wrapper.

Counterpart of the Pallas TPU kernel of `_make_dense_kernel` in
`semantic_meshes/rasterize/dense.py` and of the micro-image merge after it
(dense.py:801-808); the hand-written CUDA kernel is
`csrc/raster_dense.cu` (see the note there for its design and bound).

Inputs, all of one view: the (T+1, 16) candidate table of
`tile_kernel.candidate_table`; `sorted_ids`, the triangle ids of the
(tile, triangle) pairs grouped by tile; `starts` (B+2,), where tile b's
candidates are sorted_ids[starts[b]:starts[b+1]] and the global bucket of
big triangles is sorted_ids[starts[B]:starts[B+1]], of which every tile
tests the first `n_global`, before its own; and the micro-fragment image as
one packed int64 key per pixel, (z bits << 32) | id, +inf background.

`resolve_dense` is the one entry: for CUDA tensors it launches the kernel
(or raises), for CPU tensors it runs `resolve_dense_plain`. There is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from . import tile_kernel

TILE_H = 16
TILE_W = tile_kernel.TILE_W

# packed micro key of an empty pixel: +inf depth bits, the largest id
BG_KEY = (0x7F800000 << 32) | 0x7FFFFFFF
_INT32_MAX = 2**31 - 1

# kernel launches (a caller that counts sets it to 0 first); the plain
# version never counts
launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _kernel():
    """The C entry point of csrc/raster_dense.cu (built at first use); it
    returns cudaGetLastError() after its launch."""
    from .. import _build

    fn = _build.load("raster_dense").sm_raster_dense
    fn.argtypes = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P)
    fn.restype = ctypes.c_int
    return fn


def decode_micro(key):
    """Packed micro key image -> (depth f32 with +inf empty, ids int32 with
    -1 empty), as the JAX fragment path returns them."""
    z = (key >> 32).to(torch.int32).view(torch.float32)
    ids = (key & 0xFFFFFFFF).to(torch.int32)
    return z, torch.where(torch.isinf(z), torch.full_like(ids, -1), ids)


def merge_micro(z, ids, micro_key):
    """Lexicographic (z, id) minimum of the tile image and the micro image,
    with empty (-1) ids comparing as +inf (dense.py:801-808)."""
    zm, im = decode_micro(micro_key)
    big = torch.full_like(ids, _INT32_MAX)
    rank_t = torch.where(ids < 0, big, ids)
    rank_m = torch.where(im < 0, big, im)
    take = (zm < z) | ((zm == z) & (rank_m < rank_t))
    return torch.where(take, zm, z), torch.where(take, im, ids)


def candidates(sorted_ids, starts, n_global, sentinel):
    """(B, G + N) candidate matrix of every tile, in the kernel's order:
    the first G = min(global bucket, n_global) global ids, then the tile's
    own range, padded with `sentinel`; and the (B,) counts."""
    B = starts.numel() - 2
    device = sorted_ids.device
    s = starts.long()
    g0 = int(s[B])
    G = max(min(int(s[B + 1]) - g0, int(n_global)), 0)
    own = s[1:B + 1] - s[:B]
    N = int(own.max()) if B else 0
    slot = torch.arange(G + N, device=device)
    src = torch.where(slot[None, :] < G, g0 + slot[None, :],
                      s[:B, None] + slot[None, :] - G)
    live = (slot[None, :] < G) | (slot[None, :] - G < own[:, None])
    ext = torch.cat([sorted_ids.to(torch.int32),
                     torch.full((1,), sentinel, dtype=torch.int32,
                                device=device)])
    cand = ext[torch.where(live, src, sorted_ids.numel())]
    return cand, (G + own).to(torch.int32)


def resolve_dense_plain(table, sorted_ids, starts, n_global, micro_key,
                        y_offset, nbx, height, width):
    """Plain PyTorch dense z-resolve: same function as the CUDA kernel.
    Returns (depth (height, width) f32, ids (height, width) int32)."""
    cand, counts = candidates(sorted_ids, starts, n_global,
                              table.shape[0] - 1)
    z, ids = tile_kernel.resolve_tiles_plain(
        table, cand, counts, y_offset, nbx, height, width, tile_h=TILE_H)
    if micro_key is not None:
        z, ids = merge_micro(z, ids, micro_key)
    return z, ids


def resolve_dense_cuda(table, sorted_ids, starts, n_global, micro_key,
                       y_offset, nbx, height, width):
    """Launch csrc/raster_dense.cu on the current stream (no sync). The ids
    in `sorted_ids` must index rows of `table`."""
    global launches
    checks = [("table", table, torch.float32),
              ("sorted_ids", sorted_ids, torch.int32),
              ("starts", starts, torch.int32)]
    if micro_key is not None:
        checks.append(("micro_key", micro_key, torch.int64))
    for name, t, dtype in checks:
        if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous CUDA {dtype} tensor, got "
                f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
            )
    if table.ndim != 2 or table.shape[1] != tile_kernel.N_LANES:
        raise ValueError(f"table must be (T+1, {tile_kernel.N_LANES}), got "
                         f"{tuple(table.shape)}")
    B = starts.numel() - 2
    nby = -(-height // TILE_H)
    if nbx != -(-width // TILE_W) or B != nby * nbx:
        raise ValueError(f"starts {tuple(starts.shape)} do not hold the "
                         f"{nby}x{nbx} tiles of a {height}x{width} image")
    if micro_key is not None and tuple(micro_key.shape) != (height, width):
        raise ValueError(f"micro_key must be ({height}, {width}), got "
                         f"{tuple(micro_key.shape)}")
    if not 0 <= int(n_global) < 2**31:
        raise ValueError(f"n_global must be in [0, 2^31), got {n_global}")
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned (float4 rows)")
    kernel = _kernel()
    z = torch.empty((height, width), dtype=torch.float32, device=table.device)
    ids = torch.empty((height, width), dtype=torch.int32, device=table.device)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = kernel(
            ctypes.c_void_p(table.data_ptr()),
            ctypes.c_void_p(sorted_ids.data_ptr()),
            ctypes.c_void_p(starts.data_ptr()),
            ctypes.c_void_p(0 if micro_key is None else micro_key.data_ptr()),
            ctypes.c_void_p(z.data_ptr()),
            ctypes.c_void_p(ids.data_ptr()),
            ctypes.c_int(B), ctypes.c_int(int(n_global)), ctypes.c_int(nbx),
            ctypes.c_int(height), ctypes.c_int(width),
            ctypes.c_float(float(y_offset)),
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"raster_dense launch failed: CUDA error {err}")
    launches += 1
    return z, ids


def resolve_dense(table, sorted_ids, starts, n_global, micro_key, y_offset,
                  nbx, height, width):
    """Dense z-resolve of every tile merged with the micro image: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors. Returns
    (depth, ids), each (height, width)."""
    args = (table, sorted_ids, starts, n_global, micro_key, y_offset, nbx,
            height, width)
    if table.is_cuda:
        return resolve_dense_cuda(*args)
    if table.device.type != "cpu":
        raise ValueError(f"no z-resolve for device {table.device}")
    return resolve_dense_plain(*args)
