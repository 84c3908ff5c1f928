"""Driver entry points of the port: a one-device forward step and a
multi-device dry run.

    python -m semantic_meshes_torch.graft_entry [--devices N]
        [--device cuda|cpu]

Counterpart of the repository's `__graft_entry__.py`:

- `entry(device)` -> (fn, example_args): the flagship pipeline's forward
  step on the cube scene (two ring views of 256x192 fused into the
  (300, 19) accumulator);
- `dryrun_multichip(n_devices, device)`: one process a rank, joined by
  `torch.distributed` (NCCL on the cards, gloo with device="cpu") on a
  file:// store in a temporary directory; every rank runs the sharded
  cases of `_dryrun_impl` through `distributed.make_sharded_fuse` and
  holds each against the unsharded fusion on its own device. It raises
  RuntimeError with the failing ranks' output when a rank fails, and
  when fewer cards than ranks exist.

The ranks are plain Python processes with the repository on PYTHONPATH;
they import torch and the port, never JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 900
# the JAX package's exact16 route starts above SEGMENT_MXU_MAX_P = 3072
# segments (semantic_meshes/ops.py); its dry run fuses 257 past it. The
# port's segment sum has one route, so the case checks the size only.
LARGE_P = 3072 + 257
RTOL, ATOL = 2e-5, 1e-5


def entry(device="cuda"):
    """(fn, example_args): fn renders the cube scene's two views and
    returns their fusion's (300, 19) accumulator on `device`."""
    from . import distributed, testing
    from .data import resolve_device, stack_cameras

    device = resolve_device(device)
    height, width, classes = 192, 256, 19
    vertices, faces = testing.make_cube(subdivisions=5)
    cams = testing.make_ring_cameras(num_views=2, width=width, height=height)
    rng = np.random.default_rng(0)
    probs = np.stack(
        [testing.random_probs(rng, height, width, classes) for _ in cams])
    rot, trans, fl, pp = stack_cameras(cams)

    def fn(vertices, faces, rot, trans, fl, pp, probs, iew):
        acc, _overflow = distributed.fuse_views(
            vertices, faces, rot, trans, fl, pp, probs, iew,
            num_primitives=300, aggregator="sum", height=height,
            width=width, device=device)
        return acc

    example_args = (vertices, faces, rot, trans, fl, pp, probs,
                    np.float32(0.5))
    return fn, example_args


def _rank_command(rank, n, store, device):
    """The command line of one rank of the dry run."""
    code = ("from semantic_meshes_torch import graft_entry as g; "
            f"g._dryrun_impl({rank}, {n}, store={store!r}, "
            f"device={device!r})")
    return [sys.executable, "-c", code]


def dryrun_multichip(n_devices, device="cuda"):
    """Run the sharded cases of `_dryrun_impl` on `n_devices` ranks, one
    process each (one card each with device="cuda"). Returns each rank's
    output; raises RuntimeError with the failing ranks' output when any
    rank fails (the others are stopped), or when there are fewer cards
    than ranks."""
    from .data import resolve_device

    n = int(n_devices)
    device = resolve_device(device)
    if device.type == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"dryrun_multichip({n}) needs {n} cards, have "
                           f"{torch.cuda.device_count()}")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    if device.type == "cpu":
        # n ranks share the host's cores
        env.setdefault("OMP_NUM_THREADS",
                       str(max(1, (os.cpu_count() or 1) // n)))
    with tempfile.TemporaryDirectory() as tmp:
        logs = [os.path.join(tmp, f"rank{r}.log") for r in range(n)]
        procs = []
        try:
            for r in range(n):
                with open(logs[r], "w") as out:
                    procs.append(subprocess.Popen(
                        _rank_command(r, n, f"file://{tmp}/store",
                                      device.type),
                        stdout=out, stderr=subprocess.STDOUT, env=env,
                        cwd=ROOT))
            failed = _wait(procs)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        text = []
        for path in logs:
            with open(path) as f:
                text.append(f.read())
    if failed:
        raise RuntimeError(
            f"dryrun_multichip({n}, {device.type!r}): ranks {failed} "
            "failed\n" + "\n".join(
                f"--- rank {r} (rc {procs[r].returncode}) ---\n{text[r]}"
                for r in failed))
    return text


def _wait(procs):
    """Wait for every rank; as soon as one fails (or the time runs out)
    stop the rest, which would otherwise wait for it in a collective.
    Returns the failed ranks."""
    deadline = time.monotonic() + RANK_TIMEOUT_S
    while True:
        codes = [p.poll() for p in procs]
        failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
        if failed or all(c == 0 for c in codes):
            break
        if time.monotonic() > deadline:
            failed = [r for r, c in enumerate(codes) if c is None]
            break
        time.sleep(0.1)
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    return failed


def _close(label, got, want):
    """got == want within the dry run's tolerances, on the host."""
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL, err_msg=label)


def _nonzero(label, acc, device):
    """The accumulator summed over every rank is nonzero (a block of
    shard_primitives rows alone may be zero)."""
    import torch.distributed as dist

    total = acc.abs().sum().reshape(1).to(device)
    dist.all_reduce(total)
    if not float(total) > 0:
        raise AssertionError(f"{label}: the sharded accumulator is all zeros")


def _dryrun_impl(rank, n, *, store, device):
    """One rank of the dry run: the cases of __graft_entry__.py:107-311
    on make_sharded_fuse, each == the unsharded fuse_views /
    fuse_views_texels on this rank's device (rtol 2e-5, atol 1e-5),
    overflow 0 and a nonzero accumulator:

    - (views, pixels), with per-pixel weights and shard_primitives;
    - texel mode, mul, clip_near=True;
    - (views, pixels, faces) when n divides by 8;
    - the extended-lens wire, four models mixed in one batch, on a
      views-only mesh;
    - a fusion of LARGE_P primitives."""
    import torch.distributed as dist

    from . import distributed, geometry, testing
    from .data import stack_cameras

    distributed.initialize_multihost(store, n, rank, device=device)
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if device == "cuda" else torch.device("cpu")
    try:
        pix = 2 if n % 2 == 0 else 1
        mesh = distributed.make_device_mesh(n // pix, pix, device=device)
        height, width, classes = 64 * pix, 128, 7
        n_views = 2 * (n // pix)
        vertices, faces = testing.make_cube(subdivisions=4)  # 192 tris
        T = len(faces)
        cams = testing.make_ring_cameras(num_views=n_views, width=width,
                                         height=height)
        rng = np.random.default_rng(0)
        probs = np.stack([testing.random_probs(rng, height, width, classes)
                          for _ in cams])
        weights = rng.uniform(0.25, 1.75, size=(n_views, height, width)
                              ).astype(np.float32)
        rot, trans, fl, pp = stack_cameras(cams)
        iew = np.float32(0.5)
        kw = dict(aggregator="sum", height=height, width=width)
        ref_kw = dict(kw, device=dev)

        def check(label, fuse, args, ref, block=None):
            acc, ov = fuse(*args)
            if int(ov) != 0:
                raise AssertionError(f"{label}: dropped {int(ov)} pairs")
            if not torch.isfinite(acc).all():
                raise AssertionError(f"{label}: non-finite accumulator")
            _close(label, acc, ref if block is None else ref[block])
            _nonzero(label, acc, dev)
            print(f"rank {rank}: {label} == unsharded", flush=True)

        # (views, pixels) with weights; primitives sharded when they divide
        shard = T % n == 0
        fuse = distributed.make_sharded_fuse(
            mesh, num_primitives=T, shard_primitives=shard,
            with_weights=True, **kw)
        ref, ov = distributed.fuse_views(
            vertices, faces, rot, trans, fl, pp, probs, iew, weights,
            num_primitives=T, **ref_kw)
        if int(ov) != 0:
            raise AssertionError(f"unsharded fusion dropped {int(ov)} pairs")
        blk = T // n
        check(f"(views, pixels) {tuple(mesh.shape)} weights, "
              f"shard_primitives={shard}", fuse,
              (vertices, faces, rot, trans, fl, pp, probs, iew, weights),
              ref, slice(rank * blk, (rank + 1) * blk) if shard else None)

        # texel mode (3 texels a face), mul, near-plane clipped
        faces_t = geometry.reorder_faces_for_texels(
            torch.as_tensor(vertices), torch.as_tensor(faces)).numpy()
        resolutions = np.full((T,), 2, np.int32)
        first = np.arange(T, dtype=np.int32) * 3
        fuse_t = distributed.make_sharded_fuse(
            mesh, num_primitives=3 * T, texel_params=(resolutions, first),
            clip_near=True, **dict(kw, aggregator="mul"))
        ref_t, _ = distributed.fuse_views_texels(
            vertices, faces_t, resolutions, first, rot, trans, fl, pp, probs,
            iew, num_primitives=3 * T, clip_near=True,
            **dict(ref_kw, aggregator="mul"))
        check("texels mul clip_near", fuse_t,
              (vertices, faces_t, rot, trans, fl, pp, probs, iew), ref_t)

        # (views, pixels, faces): face blocks merged per pixel
        if n % 8 == 0:
            mesh3 = distributed.make_device_mesh(n // 4, 2, 2, device=device)
            fuse_f = distributed.make_sharded_fuse(mesh3, num_primitives=T,
                                                   **kw)
            ref_f, _ = distributed.fuse_views(
                vertices, faces, rot, trans, fl, pp, probs, iew,
                num_primitives=T, **ref_kw)
            check(f"(views, pixels, faces) {tuple(mesh3.shape)}", fuse_f,
                  (vertices, faces, rot, trans, fl, pp, probs, iew), ref_f)

        # the extended lens wire, fisheye + FOV + classic radial + thin
        # prism in one batch, on a views-only mesh (the resample gathers
        # across row bands, so no pixels axis)
        mesh_v = distributed.make_device_mesh(n, 1, device=device)
        n_dist = 2 * n
        cams_d = testing.make_ring_cameras(num_views=n_dist, width=width,
                                           height=height)
        rot_d, trans_d, fl_d, pp_d = stack_cameras(cams_d)
        dists = np.zeros((n_dist, 9), np.float32)
        dists[0::4, 0], dists[0::4, 8] = 0.03, geometry.LENS_FISHEYE
        dists[1::4, 0], dists[1::4, 8] = 0.7, geometry.LENS_FOV
        dists[2::4, 0] = 0.1  # classic SIMPLE_RADIAL zero-padded to 9
        dists[3::4, 0], dists[3::4, 8] = 0.02, geometry.LENS_THIN_PRISM
        probs_d = np.stack([testing.random_probs(rng, height, width, classes)
                            for _ in range(n_dist)])
        fuse_d = distributed.make_sharded_fuse(
            mesh_v, num_primitives=T, with_distortion=True, **kw)
        ref_d, _ = distributed.fuse_views(
            vertices, faces, rot_d, trans_d, fl_d, pp_d, probs_d, iew,
            distortions=dists, num_primitives=T, **ref_kw)
        check("extended lenses on views", fuse_d,
              (vertices, faces, rot_d, trans_d, fl_d, pp_d, probs_d, iew,
               dists), ref_d)

        # a fusion of LARGE_P primitives (most of them never seen)
        fuse_p = distributed.make_sharded_fuse(mesh, num_primitives=LARGE_P,
                                               **kw)
        ref_p, _ = distributed.fuse_views(
            vertices, faces, rot, trans, fl, pp, probs, iew,
            num_primitives=LARGE_P, **ref_kw)
        check(f"P = {LARGE_P}", fuse_p,
              (vertices, faces, rot, trans, fl, pp, probs, iew), ref_p)
    finally:
        dist.destroy_process_group()
    print(f"rank {rank}: dry run ok", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--devices", type=int, default=None,
                    help="ranks of the dry run (default: every card, or 4 "
                         "with --device cpu)")
    args = ap.parse_args(argv)
    fn, example_args = entry(args.device)
    out = fn(*example_args)
    print("entry ok:", tuple(out.shape), out.dtype, flush=True)
    n = args.devices or (torch.cuda.device_count()
                         if torch.device(args.device).type == "cuda" else 4)
    dryrun_multichip(n, args.device)
    print(f"dryrun_multichip({n}) ok", flush=True)


if __name__ == "__main__":
    main()
