"""Port of eval-scannet/create_scannet_eval_graphs.py: the paper's plots and
aggregator table from ScanNet eval result YAMLs.

    python -m semantic_meshes_torch.scripts.create_scannet_eval_graphs
        --path DIR [--min_scenes 100]

Reads DIR/*.yaml (as eval_scannet writes them), normalizes legacy
parametrizations, merges runs of equal parametrization by summing their
confusion matrices (two runs of one scene window abort), drops ScanNet
runs over fewer than --min_scenes scenes, recomputes accuracy from the
merged matrices and writes into DIR: texelres_to_accuracy.png,
imagesequalweight_to_accuracy.png, simplify_to_accuracy.png,
framesstep_to_accuracy.png and aggregators.csv. matplotlib is imported
when `main` starts, not with the module, and without it `main` fails
before it reads anything, as the JAX script does. The script works on
the host only, so it takes no `--device`.
"""

from __future__ import annotations

import argparse
import os
import sys
from collections import defaultdict
from copy import deepcopy

import numpy as np

PLOT_ARGS = {"marker": "o", "markersize": 6}
FONT_SIZE = 15


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Create graphs for finished scannet evaluations"
    )
    parser.add_argument("--path", type=str, required=True,
                        help="Path to scannet evaluation .yaml files")
    parser.add_argument("--min_scenes", type=int, default=100,
                        help="Drop scannet runs evaluated on fewer scenes; "
                        "lower it for small or synthetic datasets (the "
                        "make_paper_graphs module passes 1)")
    return parser.parse_args(argv)


def cm_to_accuracy(cm):
    cm = np.asarray(cm, np.float64)
    total = cm.sum()
    return float(np.trace(cm[:, :cm.shape[0]]) / total) if total else 0.0


def read_runs(path):
    """The result YAMLs of `path`, parametrizations normalized and
    confusion matrices under "ConfusionMatrix"."""
    import yaml

    params = []
    for fname in sorted(os.listdir(path)):
        if not fname.endswith(".yaml"):
            continue
        with open(os.path.join(path, fname)) as f:
            p = yaml.safe_load(f)
        if p is None:
            continue
        assert "path" not in p["params"]
        p["path"] = os.path.join(path, fname)
        p["params"].setdefault("aggregator", "sum")
        p["params"]["simplify"] = float(p["params"].get("simplify", 1.0))
        p["params"].setdefault("mesh", "scannet")
        p["params"].setdefault("num", 100)
        p["params"].setdefault("offset", 0)
        if "texel_resolution" not in p["params"]:
            assert p["params"]["mode"] == "triangles"
            p["params"]["texel_resolution"] = 0.0
        for group in ["image_fused", "image_network", "vertex"]:
            for key in list(p["metrics"][group].keys()):
                if key.lower().startswith("confusion_matrix") or \
                        key.startswith("ConfusionMatrix"):
                    p["metrics"][group]["ConfusionMatrix"] = np.asarray(
                        p["metrics"][group][key])
                    if key != "ConfusionMatrix":
                        del p["metrics"][group][key]
        params.append(p)
    return params


def same_parametrization(p1, p2):
    a = deepcopy(p1["params"])
    b = deepcopy(p2["params"])
    for k in ("num", "offset"):
        a.pop(k, None)
        b.pop(k, None)
    return a == b


def merge_equal_parametrizations(runs):
    """Fold runs of one parametrization (different offset/num scene
    windows of one experiment) into one: confusion matrices sum, scene
    counts add, cached scalar metrics are dropped. Two runs of the same
    window would count it twice: that exits."""
    merged = []
    for run in runs:
        target = next((m for m in merged if same_parametrization(m, run)),
                      None)
        if target is None:
            run["_offsets"] = {run["params"]["offset"]}
            merged.append(run)
            continue
        if run["params"]["offset"] in target["_offsets"]:
            print("Same offset in:")
            print(target["path"], target["params"])
            print(run["path"], run["params"])
            sys.exit(-1)
        target["_offsets"].add(run["params"]["offset"])
        print(f"Merging {run['path']} into {target['path']}")
        for group in ("image_fused", "image_network"):
            tm = target["metrics"][group]
            tm["ConfusionMatrix"] = (
                tm["ConfusionMatrix"]
                + run["metrics"][group]["ConfusionMatrix"])
            for stale in ("accuracy", "Accuracy", "mean_iou", "MeanIoU"):
                tm.pop(stale, None)
        target["params"]["num"] += run["params"]["num"]
    for m in merged:
        del m["_offsets"]
    return merged


def accuracy(p, group="image_fused"):
    m = p["metrics"][group]
    return m.get("Accuracy", m.get("accuracy"))


def percent_axis(plt):
    import matplotlib.ticker

    plt.gca().get_yaxis().set_major_formatter(
        matplotlib.ticker.FuncFormatter(lambda x, _: f"{x * 100.0:.1f}%"))


def finish(plt, path):
    plt.gcf().subplots_adjust(left=0.2, right=0.9, bottom=0.15, top=0.95)
    plt.savefig(path, dpi=300)
    plt.close(1)


def main(argv=None):
    args = parse_args(argv)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import matplotlib.ticker

    plt.rcParams.update({"font.size": FONT_SIZE})
    print("Reading yaml files...")
    params = merge_equal_parametrizations(read_runs(args.path))
    params = [p for p in params
              if not (p["params"]["mesh"] == "scannet"
                      and p["params"]["num"] < args.min_scenes)]
    for p in params:
        for group in ("image_fused", "image_network"):
            m = p["metrics"][group]
            if "Accuracy" not in m and "accuracy" not in m:
                m["Accuracy"] = cm_to_accuracy(m["ConfusionMatrix"])

    used = set()

    def report(name, ps):
        print(f"Plot: {name}")
        for p in ps:
            print(f"    {os.path.basename(p['path'])} {p['params']} "
                  f"{accuracy(p) * 100.0:.3f}")
            used.add(p["path"])

    out = args.path
    print("Creating plots...")

    # texel resolution -> accuracy
    ps = sorted((p for p in params
                 if p["params"]["frames_step"] == 1
                 and p["params"]["simplify"] == 1.0
                 and p["params"]["mesh"] == "scannet"
                 and p["params"]["images_equal_weight"] == 1.0
                 and p["params"]["aggregator"] == "mul"),
                key=lambda p: p["params"]["texel_resolution"])
    report("texelres_to_accuracy", ps)
    if ps:
        plt.figure(1)
        plt.plot([p["params"]["texel_resolution"] for p in ps],
                 [accuracy(p) for p in ps], **PLOT_ARGS)
        plt.xlabel(r"Texel resolution $\gamma$")
        plt.ylabel("Pixel accuracy")
        percent_axis(plt)
        plt.gca().set_xlim(left=0)
        finish(plt, os.path.join(out, "texelres_to_accuracy.png"))

    # images_equal_weight -> accuracy
    ps = sorted((p for p in params
                 if p["params"]["frames_step"] == 1
                 and p["params"]["mode"] == "triangles"
                 and p["params"]["images_equal_weight"] <= 1.0
                 and p["params"]["aggregator"] == "mul"
                 and p["params"]["mesh"] == "scannet"
                 and p["params"]["simplify"] == 1.0),
                key=lambda p: p["params"]["images_equal_weight"])
    report("imagesequalweight_to_accuracy", ps)
    if ps:
        plt.figure(1)
        plt.plot([p["params"]["images_equal_weight"] for p in ps],
                 [accuracy(p) for p in ps], **PLOT_ARGS)
        plt.xticks([0.0, 1.0], labels=[r"$w^{(P)}$", r"$w^{(I)}$"])
        plt.ylabel("Pixel accuracy")
        percent_axis(plt)
        finish(plt, os.path.join(out, "imagesequalweight_to_accuracy.png"))

    # aggregator table
    ps = [p for p in params
          if p["params"]["frames_step"] == 1
          and p["params"]["mode"] == "triangles"
          and p["params"]["images_equal_weight"] in (0.0, 1.0)
          and p["params"]["simplify"] == 1.0
          and p["params"]["mesh"] == "scannet"]
    report("aggregators", ps)
    aggregators = sorted({p["params"]["aggregator"] for p in ps})
    by_w = {w: {p["params"]["aggregator"]: accuracy(p)
                for p in ps if p["params"]["images_equal_weight"] == w}
            for w in (1.0, 0.0)}
    with open(os.path.join(out, "aggregators.csv"), "w") as f:
        f.write("aggregator,accuracy_w_i,accuracy_w_p\n")
        for agg in aggregators:
            f.write(f"{agg},{by_w[1.0].get(agg, float('nan'))},"
                    f"{by_w[0.0].get(agg, float('nan'))}\n")

    # simplification -> accuracy
    texel_resolutions = [0.0, 0.2]
    by_tex = defaultdict(dict)
    ps = []
    for p in params:
        if (p["params"]["frames_step"] == 1
                and p["params"]["images_equal_weight"] == 1.0
                and p["params"]["aggregator"] == "mul"
                and p["params"]["mesh"] == "scannet"
                and p["params"]["texel_resolution"] in texel_resolutions):
            ps.append(p)
            by_tex[p["params"]["texel_resolution"]][
                p["params"]["simplify"]] = p
    report("simplify_to_accuracy", ps)
    if ps:
        plt.figure(1)
        simplify_keys = sorted({p["params"]["simplify"] for p in ps})
        xs = np.asarray(simplify_keys)
        for tex, d1 in sorted(by_tex.items()):
            ys = [accuracy(d1[s]) if s in d1 else float("nan")
                  for s in simplify_keys]
            plt.plot(np.log(xs), ys, label=rf"$\gamma={tex}$", **PLOT_ARGS)
        baseline = accuracy(ps[0], "image_network")
        plt.plot(np.log(np.asarray([xs[0], xs[-1]])), [baseline, baseline],
                 label="Baseline", linestyle="--",
                 color=np.array([1.0, 0.1, 0.1]))
        plt.xlabel("Proportion of triangles")
        plt.ylabel("Pixel accuracy")
        percent_axis(plt)
        ticks = np.power(10.0, np.array([0, 1, 2]))
        plt.xticks(np.log(1.0 / ticks),
                   [f"{1.0 / t * 100.0:.1f}%" for t in ticks])
        plt.gca().set_xlim(right=0)
        plt.legend()
        finish(plt, os.path.join(out, "simplify_to_accuracy.png"))

    # frames step -> accuracy
    ps = sorted((p for p in params
                 if p["params"]["mode"] == "triangles"
                 and p["params"]["images_equal_weight"] == 1.0
                 and p["params"]["aggregator"] == "mul"
                 and p["params"]["mesh"] == "scannet"
                 and p["params"]["simplify"] == 1.0),
                key=lambda p: p["params"]["frames_step"])
    report("framesstep_to_accuracy", ps)
    if ps:
        plt.figure(1)
        xs = [1.0 / p["params"]["frames_step"] for p in ps]
        plt.plot(np.log(xs), [accuracy(p) for p in ps], **PLOT_ARGS)
        plt.xlabel("Proportion of frames")
        plt.ylabel("Pixel accuracy")
        percent_axis(plt)
        plt.gca().get_xaxis().set_major_formatter(
            matplotlib.ticker.FuncFormatter(
                lambda x, _: f"{np.exp(x) * 100.0:.1f}%"))
        ticks = np.power(10.0, np.array([0, 1, 2]))
        plt.xticks(np.log(1.0 / ticks),
                   [f"{1.0 / t * 100.0:.1f}%" for t in ticks])
        plt.gca().set_xlim(right=0)
        finish(plt, os.path.join(out, "framesstep_to_accuracy.png"))

    unused = [p for p in params if p["path"] not in used]
    if unused:
        print("Unused params:")
        for p in unused:
            print(f"    {os.path.basename(p['path'])} {p['params']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
