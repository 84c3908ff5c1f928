"""One rank of a gloo world on the CPU for the data-parallel training tests
of semantic_meshes_torch (tests/test_torch_training.py).

    python tests/_torch_train_worker.py --rank R --world N \
        --store INIT --cases CASES.json --out DIR

Imports torch, numpy and the port only (never JAX). Every rank joins the
world through distributed.initialize_multihost(INIT, N, R, device="cpu"),
then runs each case of CASES.json in order: a make_device_mesh layout,
the .npz of the global batch, and the SegmentationTrainer's keywords
(the same seed on every rank). It takes one make_data_parallel_step
and writes DIR/<case>.rank<R>.npz: the loss, the rank's local rank on
"views" and the trainer's state_dict after the step.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from semantic_meshes_torch import distributed  # noqa: E402
from semantic_meshes_torch.models import training  # noqa: E402


def main():
    parser = argparse.ArgumentParser()
    for name in ("--rank", "--world"):
        parser.add_argument(name, type=int, required=True)
    for name in ("--store", "--cases", "--out"):
        parser.add_argument(name, required=True)
    args = parser.parse_args()
    torch.set_num_threads(1)
    distributed.initialize_multihost(args.store, args.world, args.rank,
                                     device="cpu")
    with open(args.cases) as f:
        cases = json.load(f)
    for case in cases:
        mesh = distributed.make_device_mesh(*case["layout"], device="cpu")
        with np.load(case["inputs"]) as z:
            batch = {k: z[k] for k in z.files}
        trainer = training.SegmentationTrainer(**case["trainer"],
                                               device="cpu")
        step = training.make_data_parallel_step(trainer, mesh)
        loss = step(batch)
        np.savez(os.path.join(args.out, f"{case['name']}.rank{args.rank}"),
                 loss=np.float64(loss),
                 views=np.int64(mesh.get_local_rank("views")),
                 **{f"param.{k}": v.numpy()
                    for k, v in trainer.params.items()})
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
