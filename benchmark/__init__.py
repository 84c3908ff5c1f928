"""The benchmark of semantic_meshes_torch, the PyTorch and CUDA package.

One command runs one cell of `BENCHMARK.json` once:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything a cell needs is found by name: its configuration in
`configs/<config>.json`, its traffic mix in `traffic/<traffic>.json`,
each metric's reader in `metrics/<metric>.py` and the limits of the
comparison that decides `correct` in `reference/limits.json`. The plain
reference in `reference/` imports nothing of the program and nothing of
JAX; nothing here imports JAX or the JAX package `semantic_meshes`.
"""
