"""Fusion checkpoints (semantic_meshes_torch.checkpoint) and phase timers
(semantic_meshes_torch.profiling), against the JAX package's.

Mirrors, from tests/test_distributed_texels.py, test_checkpoint_roundtrip,
test_checkpoint_extensionless_path, test_state_reference_survives_add,
TestCheckpointRobustness and test_profiling_phase_timers. Adds: a JAX
checkpoint resumes in the port and a port checkpoint in the JAX package,
bit for bit (the same .npz format); a write that fails midway leaves the
old file intact; a resumed fusion equals a straight one bit for bit; the
timers' strings equal the JAX package's, and a trace holds a user
annotation per phase.
"""

import json

import numpy as np
import pytest
import torch

from semantic_meshes import checkpoint as jcheckpoint
from semantic_meshes import fusion as jfusion
from semantic_meshes import profiling as jprofiling
from semantic_meshes_torch import (checkpoint, data, fusion, profiling,
                                   render, testing)
from semantic_meshes_torch.io.ply import write_mesh

CPU = "cpu"


@pytest.fixture(scope="module")
def texel_scene(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("texels")
    vertices, faces = testing.make_cube(subdivisions=3)
    write_mesh(tmp / "cube.ply", vertices, faces)
    mesh = data.Ply(str(tmp / "cube.ply"))
    cams = testing.make_ring_cameras(num_views=3, width=128, height=96)
    renderer = render.texels(mesh, cams, 1.5, device=CPU)
    return mesh, cams, renderer


def _probs(rng, cam, C):
    W, H = cam.resolution
    return torch.from_numpy(
        testing.random_probs(rng, H, W, C).transpose(1, 0, 2).copy())


def test_checkpoint_roundtrip(tmp_path, texel_scene):
    mesh, cams, renderer = texel_scene
    P = renderer.getPrimitivesNum()
    C = 4
    rng = np.random.default_rng(5)

    agg = fusion.MeshAggregator(primitives=P, classes=C, aggregator="mul",
                                images_equal_weight=0.7, device=CPU)
    idx, _ = renderer.render(cams[0])
    agg.add(idx, _probs(rng, cams[0], C))

    path = tmp_path / "ckpt.npz"
    checkpoint.save_aggregator(path, agg, views_done=1,
                               extra={"scene": "cube"})
    agg2, views_done, extra = checkpoint.load_aggregator(path, device=CPU)
    assert views_done == 1
    assert extra == {"scene": "cube"}
    assert agg2.aggregator == "mul"
    assert agg2.images_equal_weight == 0.7
    assert agg2.device.type == "cpu"
    assert torch.equal(agg2.state, agg.state)

    # resuming: one more view on both gives identical results
    pr = _probs(rng, cams[1], C)
    idx1, _ = renderer.render(cams[1])
    agg.add(idx1, pr)
    agg2.add(idx1, pr)
    assert torch.equal(agg2.get(), agg.get())


def test_resumed_fusion_equals_straight(tmp_path, texel_scene):
    """Fuse views 0-1, save, load, fuse view 2: the accumulator equals the
    straight three-view fusion bit for bit."""
    mesh, cams, renderer = texel_scene
    P, C = renderer.getPrimitivesNum(), 5
    rng = np.random.default_rng(8)
    views = [(renderer.render(cam)[0], _probs(rng, cam, C)) for cam in cams]
    straight = fusion.MeshAggregator(P, C, device=CPU)
    for ids, pr in views:
        straight.add(ids, pr)
    first = fusion.MeshAggregator(P, C, device=CPU)
    for ids, pr in views[:2]:
        first.add(ids, pr)
    checkpoint.save_aggregator(tmp_path / "c.npz", first, views_done=2)
    resumed, done, _ = checkpoint.load_aggregator(tmp_path / "c.npz",
                                                  device=CPU)
    for ids, pr in views[done:]:
        resumed.add(ids, pr)
    assert torch.equal(resumed.state, straight.state)


def test_checkpoints_cross_between_the_packages(tmp_path):
    """The same .npz format both ways, bit for bit: a JAX snapshot resumes
    in the port, and a port snapshot in the JAX package."""
    rng = np.random.default_rng(2)
    state = rng.normal(size=(11, 3)).astype(np.float32)
    jagg = jfusion.MeshAggregator(11, 3, aggregator="summax",
                                  images_equal_weight=0.25)
    jagg.state = state
    jcheckpoint.save_aggregator(tmp_path / "j.npz", jagg, views_done=6,
                                extra={"scene": "s0"})
    agg, done, extra = checkpoint.load_aggregator(tmp_path / "j.npz",
                                                  device=CPU)
    assert (done, extra) == (6, {"scene": "s0"})
    assert (agg.primitives, agg.classes, agg.aggregator,
            agg.images_equal_weight) == (11, 3, "summax", 0.25)
    np.testing.assert_array_equal(agg.state.numpy(), state)

    agg.merge(np.ones((11, 3), np.float32))
    checkpoint.save_aggregator(tmp_path / "t.npz", agg, views_done=7,
                               extra={"scene": "s0", "n": 1})
    back, done, extra = jcheckpoint.load_aggregator(tmp_path / "t.npz")
    assert (done, extra) == (7, {"scene": "s0", "n": 1})
    assert (back.primitives, back.classes, back.aggregator,
            back.images_equal_weight) == (11, 3, "summax", 0.25)
    np.testing.assert_array_equal(np.asarray(back.state),
                                  agg.state.numpy())
    with np.load(tmp_path / "t.npz") as z:
        assert sorted(z.files) == ["meta", "state"]
        assert z["state"].dtype == np.float32 and z["meta"].dtype == np.uint8
        assert json.loads(z["meta"].tobytes())["format_version"] == 1


def test_failed_write_leaves_the_old_checkpoint(tmp_path, monkeypatch):
    agg = fusion.MeshAggregator(5, 2, device=CPU)
    agg.merge(np.full((5, 2), 3.0, np.float32))
    path = tmp_path / "ckpt.npz"
    checkpoint.save_aggregator(path, agg, views_done=3)
    before = path.read_bytes()

    def half_then_fail(f, **arrays):
        f.write(b"PK\x03\x04 half a zip")
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez_compressed", half_then_fail)
    agg.merge(np.ones((5, 2), np.float32))
    with pytest.raises(OSError, match="disk full"):
        checkpoint.save_aggregator(path, agg, views_done=4)
    assert path.read_bytes() == before
    assert not (tmp_path / "ckpt.npz.tmp").exists()
    monkeypatch.undo()
    old, done, _ = checkpoint.load_aggregator(path, device=CPU)
    assert done == 3 and float(old.state[0, 0]) == 3.0


def test_checkpoint_extensionless_path(tmp_path):
    agg = fusion.MeshAggregator(4, 3, device=CPU)
    path = tmp_path / "ckpt"  # no .npz extension
    checkpoint.save_aggregator(str(path), agg)
    agg2, _, _ = checkpoint.load_aggregator(str(path), device=CPU)
    assert agg2.primitives == 4
    assert path.exists() and not (tmp_path / "ckpt.npz").exists()


def test_state_reference_survives_add(texel_scene):
    """Holding .state across add() stays valid (add never writes in
    place)."""
    mesh, cams, renderer = texel_scene
    P = renderer.getPrimitivesNum()
    agg = fusion.MeshAggregator(P, 3, device=CPU)
    old_state = agg.state
    rng = np.random.default_rng(0)
    idx, _ = renderer.render(cams[0])
    agg.add(idx, _probs(rng, cams[0], 3))
    assert float(old_state.sum()) == 0.0
    assert float(agg.state.abs().sum()) > 0.0


class TestCheckpointRobustness:
    """Corrupt/incompatible checkpoints raise CheckpointError (a
    ValueError), never np.load's raw failure zoo."""

    def _good(self, tmp_path):
        agg = fusion.MeshAggregator(7, 3, aggregator="sum", device=CPU)
        p = tmp_path / "ckpt.npz"
        checkpoint.save_aggregator(str(p), agg, views_done=2)
        return p

    def test_corrupt_bytes_raise_typed(self, tmp_path):
        p = self._good(tmp_path)
        seed = p.read_bytes()
        rng = np.random.default_rng(0)
        cases = [
            b"",                              # empty
            b"not a checkpoint",              # not a zip
            seed[: len(seed) // 2],           # truncated
        ]
        for _ in range(40):                   # random byte flips
            data = bytearray(seed)
            for _ in range(int(rng.integers(1, 12))):
                data[rng.integers(0, len(data))] = rng.integers(0, 256)
            cases.append(bytes(data))
        bad = tmp_path / "bad.npz"
        for i, data in enumerate(cases):
            bad.write_bytes(data)
            try:
                checkpoint.load_aggregator(str(bad), device=CPU)
            except checkpoint.CheckpointError:
                pass
            except Exception as e:  # noqa: BLE001 - the assertion target
                raise AssertionError(
                    f"case {i}: leaked {type(e).__name__}: {e}"
                ) from e

    def _lying(self, tmp_path, **meta_over):
        meta = dict(
            format_version=1, primitives=7, classes=3, aggregator="sum",
            images_equal_weight=0.5, views_done=0, extra={},
        )
        meta.update(meta_over)
        p = tmp_path / "lying.npz"
        with open(p, "wb") as f:
            np.savez_compressed(
                f, state=np.zeros((7, 3), np.float32),
                meta=np.frombuffer(json.dumps(meta).encode(), np.uint8),
            )
        return p

    def test_shape_contradiction_raises(self, tmp_path):
        p = self._lying(tmp_path, primitives=9)  # lies: P=9, not 7
        with pytest.raises(checkpoint.CheckpointError, match="shape"):
            checkpoint.load_aggregator(str(p), device=CPU)

    def test_future_format_version_raises(self, tmp_path):
        p = self._lying(tmp_path, format_version=99)
        with pytest.raises(checkpoint.CheckpointError, match="format"):
            checkpoint.load_aggregator(str(p), device=CPU)

    def test_unknown_aggregator_raises_naming_it(self, tmp_path):
        p = self._lying(tmp_path, aggregator="mul-split")
        with pytest.raises(checkpoint.CheckpointError, match="mul-split"):
            checkpoint.load_aggregator(str(p), device=CPU)


def test_profiling_phase_timers():
    t = profiling.PhaseTimers()
    with t.phase("alpha"):
        pass
    with t.phase("alpha"):
        pass
    with t.phase("beta"):
        pass
    assert t.counts["alpha"] == 2
    assert t.counts["beta"] == 1
    rep = t.report()
    assert "alpha" in rep and "beta" in rep
    # median is the steady state: odd/even counts + missing phase
    t.durations["gamma"] = [5.0, 0.01, 0.02]
    assert t.median("gamma") == 0.02
    t.durations["delta"] = [0.01, 0.03, 5.0, 5.0]
    assert abs(t.median("delta") - 2.515) < 1e-9
    assert t.median("never-ran") == 0.0
    assert "ms median" in rep


def test_phase_timer_strings_equal_jax():
    """The same recorded durations give the JAX package's report() and
    as_dict() exactly."""
    t, jt = profiling.PhaseTimers(), jprofiling.PhaseTimers()
    for name, s in (("render", 0.0123456), ("fuse", 0.5), ("render", 0.02),
                    ("startup", 1.75), ("fuse", 0.25), ("fuse", 0.125)):
        t.record(name, s)
        jt.record(name, s)
    assert t.report() == jt.report()
    assert t.as_dict() == jt.as_dict()
    assert t.as_dict()["fuse"] == {"total_s": 0.875, "calls": 3,
                                   "median_s": 0.25}


def test_trace_holds_a_user_annotation_per_phase(tmp_path):
    t = profiling.PhaseTimers()
    with profiling.trace_to(tmp_path / "trace", device=CPU):
        for name in ("read", "densify", "fuse"):
            with t.phase(name):
                torch.ones(8).sum()
        with profiling.annotate("global-phase"):
            pass
    events = json.loads(
        (tmp_path / "trace" / profiling.TRACE_FILE).read_text())
    names = {e["name"] for e in events["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert {"read", "densify", "fuse", "global-phase"} <= names
    assert "global-phase" in profiling.report()


def test_trace_on_the_card_needs_one():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="is_available"):
        with profiling.trace_to("unused"):
            pass
