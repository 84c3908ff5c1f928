"""`BENCHMARK.json` and the files it names, found by name.

A cell of `workloads` names a configuration (`configs[].file`) and a
traffic mix (`traffic/<traffic>.json`); each metric, end to end or per
layer, has its reader `metrics/<name>.py`, a module with
`read(ctx) -> float | None`.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load():
    with open(BENCHMARK) as f:
        return json.load(f)


def _json(path):
    with open(path) as f:
        return json.load(f)


def cell(spec, workload):
    for w in spec["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config(spec, name):
    for c in spec["configs"]:
        if c["name"] == name:
            return _json(ROOT / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name):
    return _json(HERE / "traffic" / f"{name}.json")


def metrics_of(spec, workload, kind):
    """The entries of `kind` ("end_to_end" or "per_layer") that cell
    `workload` reports: those without a `workloads` key and those whose
    list names it."""
    return [m for m in spec[kind]
            if "workloads" not in m or workload in m["workloads"]]


def reader(name):
    """The `read` function of metrics/<name>.py."""
    path = HERE / "metrics" / f"{name}.py"
    mod_name = "benchmark.metrics._" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
