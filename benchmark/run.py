"""Run one cell of BENCHMARK.json once, on the card, and print its line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of the checkout. The last line of standard output is one
JSON object: `correct`, `attempted` (batches), `failed` (batches that
raised), `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer metrics), `device`, with `--trace 1` also
`breakdown`, then `build` (the kernel library, whether this run built
it with nvcc, and the seconds that took inside `setup_s`), and last
`checks`, each number compared with its limit. The
same numbers end standard error. The run exits 2, and prints no result,
without a CUDA card, without the program, or when JAX or the JAX package
is loaded once the window has closed.
"""

from __future__ import annotations

import time

_T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "semantic_meshes")


def forbidden_modules():
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def fail(message):
    print(f"benchmark.run: {message}", file=sys.stderr, flush=True)
    sys.exit(2)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from . import spec

    if not spec.BENCHMARK.exists():
        fail(f"{spec.BENCHMARK} not found")
    cell = spec.cell(spec.load(), args.workload)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: the benchmark runs on a "
             "CUDA card only")
    if torch.cuda.device_count() < int(cell["chips"]):
        fail(f"{args.workload} needs {cell['chips']} cards, "
             f"{torch.cuda.device_count()} found")
    try:
        import semantic_meshes_torch  # noqa: F401
    except ImportError as e:
        fail(f"the program semantic_meshes_torch cannot be imported: {e}")

    from .harness import run_cell

    result, rows = run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), device="cuda", t0=_T0)
    found = forbidden_modules()
    if found:
        fail(f"loaded in this process: {', '.join(found)}")
    for name, value, limit in rows:
        print(f"{name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
