"""Checkpoint / resume for fusion state.

Own copy of the JAX package's `semantic_meshes/checkpoint.py`, writing and
reading the same `.npz` format, so a snapshot of either package resumes in
the other: `state` is the (P, C) float32 accumulator, `meta` the uint8
JSON of the aggregator's constructor params (`format_version` 1) plus a
cursor for "how many views are already fused". The reference's resume
story is ad-hoc (npz render caches + skip-finished YAML parametrizations,
ref: eval-scannet/eval_scannet.py:70-78,170-184); here one save/load pair
resumes a fusion.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .data import resolve_device
from .fusion import MeshAggregator

_FORMAT_VERSION = 1


class CheckpointError(ValueError):
    """Corrupt/truncated/incompatible fusion checkpoint. Every load
    failure raises this (np.load's raw failure zoo: BadZipFile, EOFError,
    KeyError, JSONDecodeError)."""


def save_aggregator(path, aggregator: MeshAggregator, views_done: int = 0,
                    extra: dict | None = None):
    """Persist a MeshAggregator mid-fusion. `views_done` is the caller's
    cursor (how many views were already add()ed); `extra` is any small
    JSON-serializable metadata."""
    meta = dict(
        format_version=_FORMAT_VERSION,
        primitives=aggregator.primitives,
        classes=aggregator.classes,
        aggregator=aggregator.aggregator,
        images_equal_weight=aggregator.images_equal_weight,
        views_done=int(views_done),
        extra=extra or {},
    )
    state = aggregator.state.detach().cpu().numpy()
    # Crash-safe: write to a sibling temp file, flush+fsync, and
    # os.replace, so a kill mid-write never leaves a truncated file at
    # `path`, and a failed write removes its temp file. Written through a
    # file handle: np.savez_compressed(path, ...) appends ".npz" to
    # extensionless paths.
    tmp = str(path) + ".tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez_compressed(
                f,
                state=state,
                meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
            )
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def load_aggregator(path, device="cuda"):
    """Restore (MeshAggregator on `device`, views_done, extra) from
    save_aggregator (of this package or the JAX package).

    Raises CheckpointError on anything that is not a compatible
    checkpoint (corrupt zip, missing keys, malformed metadata, an
    aggregator this package lacks, or an accumulator whose shape
    contradicts the recorded constructor params)."""
    device = resolve_device(device)
    try:
        with np.load(path) as data:
            meta = json.loads(bytes(data["meta"].tobytes()).decode())
            fmt = meta["format_version"]
            state = data["state"]
        if fmt == _FORMAT_VERSION:
            agg = MeshAggregator(
                meta["primitives"],
                meta["classes"],
                aggregator=meta["aggregator"],
                images_equal_weight=meta["images_equal_weight"],
                device=device,
            )
            expected = (agg.primitives, agg.classes)
            got = np.shape(state)
            views_done, extra = meta["views_done"], meta["extra"]
    except Exception as e:  # noqa: BLE001 - np.load's failure zoo
        raise CheckpointError(
            f"{path}: not a valid fusion checkpoint "
            f"({type(e).__name__}: {e})"
        ) from None
    if fmt != _FORMAT_VERSION:
        raise CheckpointError(
            f"{path}: unsupported checkpoint format {fmt}"
        )
    if got != expected:
        raise CheckpointError(
            f"{path}: accumulator shape {got} contradicts the recorded "
            f"params (expected {expected})"
        )
    try:
        agg.state = state
    except (TypeError, ValueError) as e:  # e.g. a non-numeric state
        raise CheckpointError(
            f"{path}: not a valid fusion checkpoint "
            f"({type(e).__name__}: {e})"
        ) from None
    return agg, views_done, extra
