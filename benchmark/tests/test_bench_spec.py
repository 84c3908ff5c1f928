"""Every entry of BENCHMARK.json loads, and its names, units and keys are
within the benchmark's contract."""

import json
import re

import pytest

from benchmark import spec

B = spec.load()
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
# a width may never be cut (the contract's rule for `reduced`)
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|"
                   r"expansion|experts_per|_dim$|_rank$|width|height|"
                   r"classes)")


def test_top_level_keys_and_command():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(B["command"]) <= 32
    for word in B["command"]:
        assert TEXT.match(word) and not word.startswith("/")
        assert ".." not in word
    assert 1 <= len(B["paths"]) <= 16
    for p in B["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    assert len(json.dumps(B).encode()) <= 64 * 1024


def test_the_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (B["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    assert 1 <= len(B["configs"]) <= 24
    names = [c["name"] for c in B["configs"]]
    assert len(set(names)) == len(names)
    assert len({c["file"] for c in B["configs"]}) == len(names)
    used = {w["config"] for w in B["workloads"]}
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert spec.NAME.match(c["name"]) and c["name"] in used
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in B["paths"]))
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert spec.NAME.match(key) and not WIDTH.search(key)
        body = spec.config(B, c["name"])
        assert body["reduced"] == c["reduced"]
        for key in ("width", "height", "classes", "aggregator",
                    "images_equal_weight", "subdivisions",
                    "mesh_size", "frames", "pool_frames", "intrinsics",
                    "ring", "source", "assumed"):
            assert key in body


def test_workloads():
    assert 1 <= len(B["workloads"]) <= 24
    names = [w["name"] for w in B["workloads"]]
    assert len(set(names)) == len(names)
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(set(pairs)) == len(pairs)
    fours = sum(w["chips"] == 4 for w in B["workloads"])
    assert fours <= max(1, len(names) // 4)
    configs = {c["name"] for c in B["configs"]}
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert spec.NAME.match(w["name"]) and spec.NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert TEXT.match(w["why"])
        t = spec.traffic(w["traffic"])
        assert t["mode"] in ("triangles", "texels")
        assert t["entry"] in ("per_view", "chunked")
        assert t["entry"] == "chunked" or t["views_per_batch"] == 1
        c = spec.config(B, w["config"])
        assert c["pool_frames"] % t["views_per_batch"] == 0
        assert c["frames"] % t["views_per_batch"] == 0
        for key in ("views_per_batch", "warmup_batches", "trace_batches",
                    "check_batches"):
            assert int(t[key]) >= 1


def test_metrics():
    e2e = {m["name"] for m in B["end_to_end"]}
    cells = {w["name"] for w in B["workloads"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    assert 1 <= len(B["per_layer"]) <= 128
    names = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(set(names)) == len(names)
    for m in B["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0 < m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in B["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert TEXT.match(m["layer"]) and m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for m in B["end_to_end"] + B["per_layer"]:
        assert spec.NAME.match(m["name"]) and spec.UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert callable(spec.reader(m["name"]))
    for cell in cells:
        per = spec.metrics_of(B, cell, "per_layer")
        reported = {m["name"] for m in spec.metrics_of(B, cell, "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2 and per
        assert all(m["moves"] in reported for m in per)


@pytest.mark.parametrize("unit,ok", [("MPix/s", True), ("%", True),
                                     ("launches/view", True),
                                     ("tokens per s", False), ("", False)])
def test_unit_pattern(unit, ok):
    assert bool(spec.UNIT.match(unit)) is ok


@pytest.mark.parametrize("name,ok", [("device.idle_pct", True),
                                     ("_x-1.a", True), ("a b", False),
                                     ("a/b", False), ("", False),
                                     ("x" * 65, False), (".x", False)])
def test_name_pattern(name, ok):
    assert bool(spec.NAME.match(name)) is ok
