"""The readings that the limits of reference/limits.json are set from.

    python3 -m benchmark.calibrate --workload <cell>

In one process, on the card, at the cell's own sizes and load: the
program's `row_gap` over a SECONDS window on each of PROGRAM_SEEDS seeds,
then the control's on CONTROL_SEEDS other seeds: the reference put in the
program's place with its pixel values computed in bfloat16
(reference/fusion.control_delta), one step below the configuration's
float32. The lower reading is the largest of the program's, here and in
the benchmark's own runs; the upper one the smallest of the control's.
Each reading is one JSON line on standard output. The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import harness
from .reference import check

SEED_BASE = 2**31 + 4099
PROGRAM_SEEDS = 3
CONTROL_SEEDS = 3
SECONDS = 3.0


def control(program):
    """Put the control in the program's place: each batch the window
    keeps is the control's accumulator of it (the others add nothing to
    what is compared)."""
    ref = check.BatchReference(*program.scene, config=program.config,
                               traffic=program.traffic)
    program.step = lambda b, keep=False: ref.control(b) if keep else None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("benchmark.calibrate: no CUDA card", file=sys.stderr)
        sys.exit(2)
    runs = [("program", SEED_BASE + 7919 * i, None)
            for i in range(PROGRAM_SEEDS)]
    runs += [("control", SEED_BASE + 7919 * (PROGRAM_SEEDS + i), control)
             for i in range(CONTROL_SEEDS)]
    for kind, seed, hook in runs:
        result, _ = harness.run_cell(args.workload, seed, SECONDS, False,
                                     program_hook=hook)
        print(json.dumps({
            "workload": args.workload, "kind": kind, "seed": seed,
            "correct": result["correct"], "attempted": result["attempted"],
            "checks": result["checks"], "device": result["device"]}),
            flush=True)


if __name__ == "__main__":
    main()
