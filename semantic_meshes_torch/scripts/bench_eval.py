"""Port of scripts/bench_eval.py: end-to-end timing of the ScanNet eval entry
point on a synthetic 43200-face scene.

    python -m semantic_meshes_torch.scripts.bench_eval [--subdivisions 60]
        [--frames 40] [--width 1296] [--height 968]
        [--model jax-unet|probs] [--probs_dtype f32|f16|bf16]
        [--aggregator mul] [--texels] [--scenes 1] [--graphs] [--keep DIR]
        [--device cuda|cpu]

Builds the scene(s) (testing.build_synthetic_scannet_scene on
`--device`: a subdivided cube, ring cameras, posed `.sens` frames, and
for `--model probs` noisy probability maps) and times `python -m
semantic_meshes_torch.eval_scannet --timings` over it in a subprocess on
`--device` (default "cuda"; raises without a card). Prints one JSON
line: the wall time, the eval's PhaseTimers (total, calls, ms per call
and median), `steady_ms_per_frame` (the sum of the medians of the phases
run once a frame) and the frame rates it gives, and
`scene_ms_per_frame` (the phases run once a scene, such as `get` and
`vertex`, their total over the frame count). `--scenes N` builds N scenes of slightly
different sizes; `--graphs` then runs the create_scannet_eval_graphs
module over the result YAMLs.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TIMER_LINE = re.compile(
    r"^\s+([\w/ .+()-]+): ([0-9.]+)s \((\d+) calls, ([0-9.]+) ms/call"
    r"(?:, ([0-9.]+) ms median)?\)", re.M)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--subdivisions", type=int, default=60)  # 43200 faces
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--width", type=int, default=1296)
    ap.add_argument("--height", type=int, default=968)
    ap.add_argument("--model", default="jax-unet",
                    choices=["jax-unet", "probs"])
    ap.add_argument("--probs_dtype", default="f16",
                    choices=["f32", "f16", "bf16"],
                    help="With --model probs: wire dtype of the map upload")
    ap.add_argument("--aggregator", default="mul")
    ap.add_argument("--texels", action="store_true")
    ap.add_argument("--scenes", type=int, default=1)
    ap.add_argument("--graphs", action="store_true",
                    help="run create_scannet_eval_graphs on the result "
                    "YAMLs afterwards")
    ap.add_argument("--keep", help="directory to build the scene in "
                    "(reused if it already exists)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device of the scene builder and the eval "
                    "(cuda, or cpu)")
    return ap.parse_args(argv)


def parse_timers(stdout):
    """{phase: {total_s, calls, ms_per_call[, ms_median]}} from the
    PhaseTimers report in `stdout`."""
    return {k: {"total_s": float(t), "calls": int(n),
                "ms_per_call": float(ms),
                **({"ms_median": float(med)} if med else {})}
            for k, t, n, ms, med in TIMER_LINE.findall(stdout)}


def main(argv=None):
    args = parse_args(argv)
    from .. import testing
    from ..data import resolve_device

    resolve_device(args.device)
    root = args.keep or tempfile.mkdtemp(prefix="sm_bench_eval_")
    built = []
    for s in range(args.scenes):
        name = f"scene{s:04d}_00"
        if os.path.exists(os.path.join(root, "scans", name, f"{name}.sens")):
            continue
        os.makedirs(os.path.join(root, "scans"), exist_ok=True)
        testing.write_scannet_label_tsv(
            os.path.join(root, "scannetv2-labels.combined.tsv"))
        t0 = time.perf_counter()
        # later scenes a little larger and noisier
        faces, views = testing.build_synthetic_scannet_scene(
            root, name, subdivisions=args.subdivisions + 2 * s,
            num_views=args.frames, width=args.width, height=args.height,
            write_probs=(args.model == "probs"),
            prob_noise=0.2 if args.model == "probs" else 0.0,
            noise_seed=s, device=args.device,
        )
        built.append({"scene": name, "faces": faces, "frames": views,
                      "seconds": round(time.perf_counter() - t0, 1)})
    if built:
        print(json.dumps({"scenes_built": built}), flush=True)

    out = os.path.join(root, "results")
    cmd = [sys.executable, "-m", "semantic_meshes_torch.eval_scannet",
           "--scannet", root, "--model", args.model,
           "--aggregator", args.aggregator, "--output", out, "--timings",
           "--device", args.device]
    if args.model == "probs":
        cmd += ["--probs_dir", os.path.join(root, "probs"),
                "--probs_dtype", args.probs_dtype]
    if args.texels:
        cmd += ["--mode", "texels"]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    sys.stderr.write(proc.stdout[-3000:] + proc.stderr[-3000:])
    if proc.returncode != 0:
        raise SystemExit(f"eval failed rc={proc.returncode}")

    # the medians are the steady state: first calls carry one-time costs
    # (kernel builds, allocator growth); a phase called no more often than
    # there are scenes runs once a scene
    timers = parse_timers(proc.stdout)
    steady_ms = sum(v.get("ms_median", v["ms_per_call"])
                    for v in timers.values() if v["calls"] > args.scenes)
    scene_s = sum(v["total_s"] for v in timers.values()
                  if v["calls"] <= args.scenes)
    result = {
        "metric": "eval_e2e",
        "scenes": args.scenes,
        "frames": args.frames,
        "model": args.model,
        "aggregator": args.aggregator,
        **({"probs_dtype": args.probs_dtype}
           if args.model == "probs" else {}),
        "device": args.device,
        "total_wall_s": round(wall, 1),
        "steady_ms_per_frame": round(steady_ms, 1),
        "steady_frames_per_s": round(1e3 / steady_ms, 2) if steady_ms
        else None,
        "scene_ms_per_frame": round(
            1e3 * scene_s / (args.scenes * args.frames), 1),
        "e2e_frames_per_s": round(args.scenes * args.frames / wall, 2),
        "timers": timers,
    }
    if args.graphs:
        t0 = time.perf_counter()
        gproc = subprocess.run(
            [sys.executable, "-m",
             "semantic_meshes_torch.scripts.create_scannet_eval_graphs",
             "--path", out, "--min_scenes", "1"],
            env=env, capture_output=True, text=True)
        if gproc.returncode != 0:
            sys.stderr.write(gproc.stdout + gproc.stderr)
            raise SystemExit(f"graphs failed rc={gproc.returncode}")
        result["graphs"] = {
            "seconds": round(time.perf_counter() - t0, 1),
            "files": sorted(f for f in os.listdir(out)
                            if f.endswith((".png", ".csv"))),
        }
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
