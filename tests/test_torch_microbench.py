"""The port's microbenches (semantic_meshes_torch.scripts.microbench_*):
each main runs at tiny sizes on the CPU and prints its JSON lines; the
tile-fusion reduce equals the flat segment sum; the segment-sum probes
hold float64's answer."""

import importlib
import json

import pytest
import torch

from semantic_meshes_torch.scripts import microbench_tile_fusion as tf
from semantic_meshes_torch.scripts.microbench_segment_sum import PROBES

SCENE = ["--width", "256", "--height", "192", "--repeats", "1",
         "--device", "cpu"]
RUNS = {
    "microbench_scannet": ["--subdivisions", "20", "--views", "2",
                           "--classes", "5"] + SCENE,
    "microbench_dense": ["--subdivisions", "20"] + SCENE,
    "microbench_microrows": ["--subdivisions", "20"] + SCENE,
    "microbench_tile_fusion": ["--subdivisions", "20", "--classes",
                               "5"] + SCENE,
}
RUNS.update({f"microbench_segment_sum {p}": [
    "--probe", p, "--scale", "0.002", "--repeats", "1", "--device", "cpu"]
    for p in PROBES})
PHASES = {
    "microbench_scannet": {
        "full planned step", "fuse_views_planned per view",
        "dense.rasterize", "setup + classify + sorted binning",
        "setup + classify + sorted binning + table", "setup + micro path",
        "fusion"},
    "microbench_dense": {"setup", "build_sorted_bins", "rasterize_micro",
                         "full_dense_rasterize"},
    "microbench_tile_fusion": {"flat segment sum",
                               "tile bmm + candidate-row segment sum",
                               "two-class tile reduce"},
}


@pytest.fixture(autouse=True)
def one_torch_thread(monkeypatch):
    """Beside other test workers on the same cores, a pool of intra-op
    threads per op waits on the scheduler at every op, so each test runs
    on one thread, and the processes it starts on one too."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yield
    torch.set_num_threads(threads)


def _module(name):
    return importlib.import_module(
        "semantic_meshes_torch.scripts." + name.split()[0])


def _lines(capsys):
    return [json.loads(line) for line in
            capsys.readouterr().out.splitlines() if line.strip()]


@pytest.mark.parametrize("name", sorted(RUNS))
def test_microbench_prints_its_json_lines(name, capsys):
    _module(name).main(RUNS[name])
    lines = _lines(capsys)
    assert lines
    module = name.split()[0]
    timed = [line for line in lines if "ms" in line]
    if module in PHASES:
        assert {line["phase"] for line in timed} == PHASES[module]
        assert all(line["ms"] > 0 for line in timed)
    if module == "microbench_scannet":
        assert [line["routing_micro_max"] for line in lines
                if "routing_micro_max" in line] == [1, 2, 3, 4, 6]
    if module == "microbench_microrows":
        caps = [line["micro_cap"] for line in lines if "micro_cap" in line]
        assert caps == [4800, 3600, 2400]
        assert "ns_per_row" in lines[-1]
    if module == "microbench_tile_fusion":
        checks = [line for line in lines if "check" in line]
        assert len(checks) == 2
        assert all(c["max_rel"] <= 1e-5 for c in checks)
    if module == "microbench_segment_sum":
        probe = RUNS[name][1]
        routes = [line["route"] for line in lines]
        assert routes.count("ops.segment_sum") == routes.count("index_add_")
        assert all(line["probe"] == probe for line in lines)
        errors = [line["max_rel_error_vs_float64"] for line in lines
                  if "max_rel_error_vs_float64" in line]
        if probe in ("scatter", "exact16"):
            assert errors and max(errors) < 1e-5
        else:
            assert not errors


def test_tile_reduce_equals_the_flat_segment_sum():
    """Both tile reduces equal the flat per-pixel sum within float32
    reassociation (rtol 1e-5): the kmax one on the binned candidates'
    rows, the two-class one on the pixels it accounts for (which are all
    of them where a tile's list holds its winner)."""
    from semantic_meshes_torch.rasterize import dense, tiles
    from semantic_meshes_torch.scripts import _microbench as mb

    H, W, C = 160, 300, 4
    sc = mb.scene(18, 1, W, H, "cpu")
    cam, P = sc.cams[0], sc.T
    gen = torch.Generator().manual_seed(1)
    data = torch.rand((H, W, C + 1), generator=gen)
    pairs, micro = dense.candidate_stats(None, None, *cam,
                                         face_vertices=sc.fv, height=H,
                                         width=W, device="cpu").tolist()
    idx = dense.rasterize(None, None, *cam, face_vertices=sc.fv, height=H,
                          width=W, e_cap_rows=2 * pairs,
                          micro_cap_rows=2 * micro, device="cpu")[0]
    setup = tiles.setup_inputs(None, None, *cam, sc.fv, "cpu")
    sorted_ids, starts, overflow, _ = dense._build_sorted_bins(
        setup, H, W, 0.0, 2 * pairs + dense.CHUNK, dense.N_GLOBAL)
    assert int(overflow) == 0
    B = starts.shape[0] - 2
    kmax = int((starts[1:B + 1] - starts[:B]).max())
    flat = tf.flat_sum(idx, data, P)
    rows = tf.binned_rows(sorted_ids, starts, P)
    assert 0 < len(rows) < P
    got = tf.tile_reduce(idx, data, sorted_ids, starts, P, kmax)
    torch.testing.assert_close(got[rows], flat[rows], rtol=1e-5, atol=1e-6)
    # the rows of micro and global-bucket triangles are the flat sum's
    # alone
    others = torch.ones(P, dtype=torch.bool)
    others[rows] = False
    assert float(got[others].abs().sum()) == 0.0
    ktile = 64
    heavy = int((tf._heavy(starts, ktile)).sum())
    assert 0 < heavy < B
    got2 = tf.tile_reduce_two_class(idx, data, sorted_ids, starts, P, ktile)
    want2 = tf.two_class_oracle(idx, data, sorted_ids, starts, P, ktile)
    torch.testing.assert_close(got2, want2, rtol=1e-5, atol=1e-6)
    # a tile layout round trip: tile b holds rows [16 by, 16 by + 16) and
    # columns [128 bx, 128 bx + 128)
    t = tf.tile_view(idx, -1)
    nbx = -(-W // dense.TILE_W)
    assert torch.equal(t[nbx + 1].reshape(16, 128),
                       idx[16:32, 128:256])


@pytest.mark.parametrize("name", [
    "microbench_scannet", "microbench_dense", "microbench_microrows",
    "microbench_tile_fusion", "microbench_segment_sum"])
def test_microbench_defaults_to_the_card_without_fallback(name, monkeypatch):
    module = _module(name)
    argv = ["--probe", "exact16"] if name == "microbench_segment_sum" else []
    assert module.parse_args(argv).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        module.main(argv)
