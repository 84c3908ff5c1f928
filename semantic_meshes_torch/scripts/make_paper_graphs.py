"""Port of scripts/make_paper_graphs.py: the paper's evaluation figures end
to end on synthetic ScanNet scenes.

    python -m semantic_meshes_torch.scripts.make_paper_graphs --out DIR
        [--scenes 2] [--views 6] [--subdivisions 6] [--width 160]
        [--height 120] [--noise 0.6] [--grid full|smoke]
        [--device cuda|cpu]

Builds seeded noisy scenes (testing.build_synthetic_scannet_scene: later
frames are noisier, so the weighting and the aggregator move the fused
accuracy; the full grid also writes coarser meshes under the simplified
names), runs the eval grid through `python -m
semantic_meshes_torch.eval_scannet` (one process a point, on `--device`,
default "cuda"; raises without a card) and then
`python -m semantic_meshes_torch.scripts.create_scannet_eval_graphs`,
writing DIR/results/*.yaml, the four plots and aggregators.csv. Scenes
and results of an earlier run with the same build flags are reused.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SIMPLIFY_FACTORS = ("0.25", "0.0625")


def grid_points(grid):
    """The eval grid as eval_scannet argument dicts: "full" covers every
    plot and the aggregator table (aggregator x weight, a weight sweep, a
    texel-resolution sweep, a frames-step point, the simplification
    sweep in both modes); "smoke" is a 3-run subset."""
    points = []
    if grid == "smoke":
        for agg in ("sum", "mul"):
            points.append({"aggregator": agg, "images_equal_weight": 1.0})
        points.append({
            "aggregator": "mul", "images_equal_weight": 1.0,
            "mode": "texels", "texel_resolution": 0.1,
        })
        return points
    for agg in ("sum", "summax", "mul"):
        for w in (0.0, 1.0):
            points.append({"aggregator": agg, "images_equal_weight": w})
    points.append({"aggregator": "mul", "images_equal_weight": 0.5})
    for tex in (0.05, 0.1, 0.2):
        points.append({
            "aggregator": "mul", "images_equal_weight": 1.0,
            "mode": "texels", "texel_resolution": tex,
        })
    points.append({
        "aggregator": "mul", "images_equal_weight": 1.0, "frames_step": 2,
    })
    for factor in SIMPLIFY_FACTORS:
        points.append({
            "aggregator": "mul", "images_equal_weight": 1.0,
            "simplify": factor,
        })
        points.append({
            "aggregator": "mul", "images_equal_weight": 1.0,
            "simplify": factor, "mode": "texels", "texel_resolution": 0.2,
        })
    return points


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--scenes", type=int, default=2)
    ap.add_argument("--views", type=int, default=6)
    ap.add_argument("--subdivisions", type=int, default=6)
    ap.add_argument("--width", type=int, default=160)
    ap.add_argument("--height", type=int, default=120)
    ap.add_argument("--noise", type=float, default=0.6,
                    help="max per-frame label-flip probability (frame i "
                         "gets noise * i / (views - 1))")
    ap.add_argument("--grid", default="full", choices=("full", "smoke"))
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device of the scene builder and the eval "
                    "runs (cuda, or cpu)")
    return ap.parse_args(argv)


def child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    return env


def main(argv=None):
    args = parse_args(argv)
    from .. import testing
    from ..data import resolve_device

    resolve_device(args.device)
    root = os.path.join(args.out, "scannet")
    results = os.path.join(args.out, "results")
    os.makedirs(os.path.join(root, "scans"), exist_ok=True)
    os.makedirs(results, exist_ok=True)
    testing.write_scannet_label_tsv(
        os.path.join(root, "scannetv2-labels.combined.tsv"))
    build_params = {
        "scenes": args.scenes,
        "subdivisions": args.subdivisions, "views": args.views,
        "width": args.width, "height": args.height, "noise": args.noise,
        "grid": args.grid,
    }
    # the eval skips a grid point whose params match an existing YAML, and
    # the build flags are not among those params: clear results made with
    # other flags
    results_marker = os.path.join(results, ".sm_build_params.json")
    stale = True
    if os.path.isfile(results_marker):
        with open(results_marker) as f:
            stale = json.load(f) != build_params
    if stale:
        for f in os.listdir(results):
            if f.endswith((".yaml", ".png", ".csv")):
                os.remove(os.path.join(results, f))
        with open(results_marker, "w") as f:
            json.dump(build_params, f)
    for i in range(args.scenes):
        name = f"scene{i:04d}_00"
        scene_dir = os.path.join(root, "scans", name)
        marker = os.path.join(scene_dir, ".sm_synthetic_build.json")
        # reuse only a complete scene of the same flags (the marker is
        # written last)
        if os.path.isfile(marker):
            with open(marker) as f:
                if json.load(f) == build_params:
                    continue
        if os.path.isdir(scene_dir):
            print(f"Rebuilding stale/partial scene {name} ...")
            shutil.rmtree(scene_dir)
            shutil.rmtree(os.path.join(root, "probs", name),
                          ignore_errors=True)
        else:
            print(f"Building synthetic scene {name} ...")
        testing.build_synthetic_scannet_scene(
            root, name, subdivisions=args.subdivisions,
            num_views=args.views, width=args.width, height=args.height,
            prob_noise=args.noise, noise_seed=i,
            simplify_factors=(SIMPLIFY_FACTORS if args.grid == "full"
                              else ()),
            device=args.device,
        )
        with open(marker, "w") as f:
            json.dump(build_params, f)

    env = child_env()
    points = grid_points(args.grid)
    for k, point in enumerate(points):
        print(f"[{k + 1}/{len(points)}] eval {point}", flush=True)
        cmd = [sys.executable, "-m", "semantic_meshes_torch.eval_scannet",
               "--scannet", root, "--model", "probs",
               "--probs_dir", os.path.join(root, "probs"),
               "--output", results, "--device", args.device]
        for key, value in point.items():
            cmd += [f"--{key}", str(value)]
        subprocess.run(cmd, check=True, env=env)

    print("Creating plots ...", flush=True)
    subprocess.run(
        [sys.executable, "-m",
         "semantic_meshes_torch.scripts.create_scannet_eval_graphs",
         "--path", results, "--min_scenes", "1"],
        check=True, env=env)
    made = sorted(f for f in os.listdir(results)
                  if f.endswith((".png", ".csv")))
    print(f"Done. Artifacts in {results}: {', '.join(made)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
