"""Port of scripts/tpu_resume_killtest.py: the ScanNet eval entry point's
checkpoint resume under SIGKILL, on the card.

    python -m semantic_meshes_torch.scripts.resume_killtest [--workdir DIR]
        [--subdivisions 8] [--views 16] [--width 320] [--height 240]
        [--timeout 3600] [--cpu] [--device cuda|cpu]

The parent builds two synthetic scenes on the CPU
(testing.build_synthetic_scannet_scene). Its children run `python -m
semantic_meshes_torch.eval_scannet --model jax-unet` (the bundled RGBD
UNet, random weights from seed 0) on `--device` (default "cuda"; raises
without a card; `--cpu` is `--device cpu`): an uninterrupted run, then a
run with `--checkpoint --checkpoint_every 1` that is sent SIGKILL the
moment its first manifest lands, then the same command again, which
must resume. The
resumed YAML's metrics must equal the uninterrupted run's exactly:
accuracy, mean IoU and every confusion-matrix cell, in every group.
Prints one JSON line with PASS or FAIL and the wall times; exits 1 on
FAIL.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GROUPS = ("vertex", "image_network", "image_fused")
MODEL = "jax-unet"
CHECKPOINT_EVERY = 1


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--subdivisions", type=int, default=8)
    ap.add_argument("--views", type=int, default=16)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device of the eval children (cuda, or cpu)")
    ap.add_argument("--cpu", action="store_const", const="cpu",
                    dest="device",
                    help="run the eval children on the CPU (--device cpu)")
    return ap.parse_args(argv)


def mismatches(ref, got):
    """The metrics of `got` that differ from `ref` in any bit; a
    confusion matrix as "<group>.confusion_matrix: <cells> cells, <sum of
    |difference|>"."""
    import numpy as np

    bad = []
    for group in GROUPS:
        for key in ("accuracy", "mean_iou", "confusion_matrix"):
            a, b = got["metrics"][group][key], ref["metrics"][group][key]
            if a == b:
                continue
            if key == "confusion_matrix":
                d = np.abs(np.asarray(a, np.float64) - np.asarray(b))
                bad.append(f"{group}.{key}: {int((d > 0).sum())} cells, "
                           f"{d.sum():g}")
            else:
                bad.append(f"{group}.{key}")
    return bad


def main(argv=None):
    args = parse_args(argv)
    from .. import testing
    from ..data import resolve_device

    device = args.device
    resolve_device(device)
    work = args.workdir or tempfile.mkdtemp(prefix="sm_killtest_")
    root = os.path.join(work, "scannet")
    for i in range(2):
        testing.build_synthetic_scannet_scene(
            root, f"scene{i:04d}_00", subdivisions=args.subdivisions,
            num_views=args.views, width=args.width, height=args.height,
            device="cpu")
    testing.write_scannet_label_tsv(
        os.path.join(root, "scannetv2-labels.combined.tsv"))

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)

    def cmd(out, extra):
        c = [sys.executable, "-m", "semantic_meshes_torch.eval_scannet",
             "--scannet", root, "--model", MODEL, "--aggregator", "sum",
             "--output", out, "--device", device]
        return c + extra

    def fail(stage):
        print(json.dumps({"killtest": "FAIL", "stage": stage}), flush=True)
        return 1

    t0 = time.time()
    ref_out = os.path.join(work, "ref")
    proc = subprocess.run(cmd(ref_out, []), env=env, capture_output=True,
                          text=True, timeout=args.timeout)
    t_ref = time.time() - t0
    if proc.returncode != 0:
        print(proc.stdout + proc.stderr, file=sys.stderr)
        return fail("reference run")

    ck = os.path.join(work, "ckpt")
    out = os.path.join(work, "resumed")
    ck_args = ["--checkpoint", ck,
               "--checkpoint_every", str(CHECKPOINT_EVERY)]
    t1 = time.time()
    child = subprocess.Popen(cmd(out, ck_args), env=env,
                             stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL)
    manifest = os.path.join(ck, "manifest.npz")
    deadline = time.time() + args.timeout
    try:
        while not os.path.isfile(manifest):
            if child.poll() is not None:
                return fail(f"eval exited rc={child.returncode} before "
                            "first checkpoint")
            if time.time() > deadline:
                return fail("checkpoint timeout")
            time.sleep(0.05)
        child.send_signal(signal.SIGKILL)
        killed_at = time.time()
        child.wait(timeout=120)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()

    t2 = time.time()
    proc = subprocess.run(cmd(out, ck_args), env=env, capture_output=True,
                          text=True, timeout=args.timeout)
    t_resume = time.time() - t2
    if proc.returncode != 0 or "Resuming" not in proc.stdout:
        print(proc.stdout + proc.stderr, file=sys.stderr)
        return fail("resume run")

    import yaml

    with open(os.path.join(ref_out, "run-1.yaml")) as f:
        ref = yaml.safe_load(f)
    with open(os.path.join(out, "run-1.yaml")) as f:
        got = yaml.safe_load(f)
    bad = mismatches(ref, got)
    print(json.dumps({
        "killtest": "PASS" if not bad else "FAIL",
        "mismatches": bad,
        "device": device,
        "model": MODEL,
        "reference_run_s": round(t_ref, 1),
        "killed_after_s": round(killed_at - t1, 1),
        "resume_run_s": round(t_resume, 1),
        "scenes": 2,
        "views_per_scene": args.views,
        "resolution": [args.width, args.height],
        "workdir": work,
    }), flush=True)
    return 0 if not bad else 1


if __name__ == "__main__":
    sys.exit(main())
