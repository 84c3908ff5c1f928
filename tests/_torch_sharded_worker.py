"""One rank of a gloo world on the CPU for the sharded-fuse tests of
semantic_meshes_torch (tests/test_torch_sharded_*.py,
tests/test_torch_collective_structure.py, tests/test_torch_multihost.py).

    python tests/_torch_sharded_worker.py --rank R --world N \
        --store INIT --cases CASES.json --out DIR

Imports torch, numpy and the port only (never JAX). Every rank joins the
world through distributed.initialize_multihost(INIT, N, R, device="cpu")
(INIT is file:///path or host:port), then runs each case of CASES.json in
order: a make_device_mesh layout, the .npz of global inputs, the names of
the fuse's positional arguments and make_sharded_fuse's keywords. It
writes DIR/<case>.rank<R>.npz: the accumulator and overflow (twice with
"repeat"), the rank's mesh coordinates, the collectives recorded (JSON),
the merged face-block ids of its views' bands ("face_ids"), or the
ValueError's message when one was raised ("error").
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from semantic_meshes_torch import distributed  # noqa: E402
from semantic_meshes_torch import rasterize as rast  # noqa: E402


def fuse_kwargs(case, inputs):
    kw = dict(case["kwargs"])
    if "texel_params" in kw:
        kw["texel_params"] = tuple(inputs[k] for k in kw["texel_params"])
    if kw.get("dense_e_cap") is not None:
        # JSON holds the JAX tuple form; the fuse is handed its record
        kw["dense_e_cap"] = rast.dense.DenseBudget.of(
            tuple(kw["dense_e_cap"]))
    return kw


def band_face_ids(mesh, inputs, kw):
    """The merged face-block winners of this rank's views and row band:
    (views on this rank, band rows, W) int32 global ids, -1 empty."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    axis = distributed.MeshAxis(mesh, ("faces",))
    v, p, f = (mesh.get_local_rank(n) for n in ("views", "pixels", "faces"))
    H, W = kw["height"], kw["width"]
    band = H // sizes["pixels"]
    faces = inputs["faces"]
    blk = len(faces) // sizes["faces"]
    nloc = len(inputs["rot"]) // sizes["views"]
    out = []
    for i in range(v * nloc, (v + 1) * nloc):
        tri, depth, _ = rast.rasterize(
            inputs["vertices"], faces[f * blk:(f + 1) * blk], inputs["rot"][i],
            inputs["trans"][i], inputs["fl"][i], inputs["pp"][i],
            y_offset=p * band, height=band, width=W,
            clip_near=kw.get("clip_near", False),
            backend=kw.get("backend"), device="cpu")
        out.append(distributed.merge_face_blocks(tri, depth, f * blk, axis))
    return torch.stack(out).numpy()


def run_case(case, rank, meshes, out_dir):
    inputs = dict(np.load(case["inputs"]))
    layout = tuple(case["layout"])
    if layout not in meshes:
        meshes[layout] = distributed.make_device_mesh(*layout, device="cpu")
    mesh = meshes[layout]
    kw = fuse_kwargs(case, inputs)
    log = []
    res = {"coords": np.array([mesh.get_local_rank(n)
                               for n in mesh.mesh_dim_names])}
    try:
        fuse = distributed.make_sharded_fuse(mesh, collectives=log, **kw)
        args = [inputs[k] for k in case["args"]]
        for k in range(2 if case.get("repeat") else 1):
            acc, overflow = fuse(*args)
            res[f"acc{k}"] = acc.numpy()
            res[f"overflow{k}"] = np.asarray(int(overflow))
    except ValueError as e:
        res["error"] = np.asarray(str(e))
    res["collectives"] = np.asarray(json.dumps([c._asdict() for c in log]))
    if case.get("face_ids"):
        res["face_ids"] = band_face_ids(mesh, inputs, kw)
    np.savez(os.path.join(out_dir, f"{case['name']}.rank{rank}.npz"), **res)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--cases", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    torch.set_num_threads(1)
    for _ in range(2):  # the second call finds the group and returns
        distributed.initialize_multihost(args.store, args.world, args.rank,
                                         device="cpu")
    with open(args.cases) as fh:
        cases = json.load(fh)
    meshes = {}
    for case in cases:
        run_case(case, args.rank, meshes, args.out)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]
    if bad:
        sys.exit(f"rank {args.rank} imported {bad}")
    print(f"rank {args.rank} ok", flush=True)


if __name__ == "__main__":
    main()
