"""The whole run, on the CPU at a small size, with the look for a card
skipped: it is correct as it stands, and not correct with the timed path
broken underneath (each fault the cells can have) or with the control
in the program's place. The last test runs a cell on the card."""

import pytest
import torch

from benchmark import calibrate, harness, spec
import semantic_meshes_torch.distributed as program_distributed
import semantic_meshes_torch.fusion as program_fusion

SMALL = dict(width=96, height=72, classes=5, subdivisions=38, frames=12,
             pool_frames=4, mesh_size=1.0,
             intrinsics=dict(focal=[64.8, 64.8], principal=[48.0, 36.0]),
             ring=dict(radius=3.0, elevation=0.35, target=[0.0, 0.0, 0.0],
                       jitter=dict(angle_steps=0.5, radius=0.02,
                                   elevation=0.02, target=0.02)))
SHORT = dict(check_batches=3, warmup_batches=1, trace_batches=2)
# every cell, and the eval's texel traffic where no cell drives it
CASES = [(w["name"], None) for w in spec.load()["workloads"]]
if "eval-texels" not in {w["traffic"] for w in spec.load()["workloads"]}:
    CASES.append(("scannet-eval.triangles", "eval-texels"))
IDS = [c if t is None else f"{c}+{t}" for c, t in CASES]


def run(case, hook=None, seconds=0.3, trace=False):
    workload, traffic = case
    overrides = dict(spec.traffic(traffic)) if traffic else {}
    overrides.update(SHORT)
    result, rows = harness.run_cell(
        workload, 2**31 + 11, seconds, trace, device="cpu",
        config_overrides=SMALL, traffic_overrides=overrides,
        program_hook=hook)
    return result


def entry(case):
    workload, traffic = case
    name = traffic or spec.cell(spec.load(), workload)["traffic"]
    return spec.traffic(name)["entry"]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_a_sound_run_is_correct(case):
    result = run(case)
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] >= 1
    assert set(result["metrics"]) == {
        m["name"] for m in spec.metrics_of(spec.load(), case[0],
                                           "end_to_end")}
    checks = result["checks"]
    assert list(result)[-1] == "checks"
    assert checks["row_gap"]["value"] <= checks["row_gap"]["limit"]
    assert set(checks) == {"row_gap", "overflow", "failed", "primitives"}


@pytest.mark.parametrize("case", CASES[:2], ids=IDS[:2])
def test_a_traced_run_is_correct_and_has_its_breakdown(case):
    result = run(case, trace=True)
    assert result["correct"] and result["attempted"] == 4
    assert "breakdown" in result and result["device"]["window_s"] > 0


def unchanged(program):
    """A step that returns the state unchanged: it adds nothing."""
    def step(b, keep=False):
        acc = torch.zeros_like(program.aggregator.state)
        return acc if keep else None
    program.step = step


def overflowing(program):
    """Dropped pairs reported."""
    overflow = program.overflow
    program.overflow = lambda: overflow() + 1


def raising(program):
    """Every other batch raises."""
    step = program.step

    def odd(b, keep=False):
        if b % 2:
            raise RuntimeError("planted")
        return step(b, keep)
    program.step = odd


@pytest.fixture
def shifted(monkeypatch):
    """An answer altered where it is produced: each view's primitive
    image moved by one pixel before it is fused."""
    fuse = program_fusion._accumulate_view

    def accumulate(prim, *args, **kwargs):
        return fuse(torch.roll(prim, 1, dims=-1), *args, **kwargs)
    monkeypatch.setattr(program_fusion, "_accumulate_view", accumulate)


@pytest.fixture
def half(monkeypatch):
    """Half of each batch left out, the mean taken over the rest: half
    of the views of a chunk, or half of the pixel rows of a batch of
    one view."""
    fuse_views = program_distributed.fuse_views
    accumulate = program_fusion._accumulate_view

    def half_views(vertices, faces, rotations, translations, focal_lengths,
                   principal_points, probs, *args, **kwargs):
        n = len(rotations) // 2
        acc, ov = fuse_views(vertices, faces, rotations[:n],
                             translations[:n], focal_lengths[:n],
                             principal_points[:n], probs[:n], *args,
                             **kwargs)
        return acc * 2, ov

    def half_rows(prim, probs, weights, *args, **kwargs):
        n = prim.shape[0] // 2
        return 2 * accumulate(prim[:n], probs[:n],
                              None if weights is None else weights[:n],
                              *args, **kwargs)

    def plant(kind):
        if kind == "chunked":
            monkeypatch.setattr(program_distributed, "fuse_views",
                                half_views)
        else:
            monkeypatch.setattr(program_fusion, "_accumulate_view",
                                half_rows)
    return plant


@pytest.mark.parametrize("fault", [unchanged, overflowing, raising])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_a_broken_step_is_not_correct(case, fault):
    assert not run(case, fault)["correct"]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_half_the_batch_is_not_correct(case, half):
    half(entry(case))
    result = run(case)
    assert not result["correct"]
    assert result["checks"]["row_gap"]["value"] > 1e-2


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_an_altered_answer_is_not_correct(case, shifted):
    result = run(case)
    assert not result["correct"]
    assert result["checks"]["row_gap"]["value"] > 1e-2


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_the_control_is_not_correct(case):
    """The reference in the program's place, its pixel values in
    bfloat16: its row_gap passes the limit (calibrate.py reads the same
    on the card at the cells' own sizes)."""
    result = run(case, calibrate.control, seconds=0.1)
    assert not result["correct"]
    checks = result["checks"]
    assert checks["row_gap"]["value"] > 3 * checks["row_gap"]["limit"]


@pytest.mark.gpu
def test_a_short_run_on_the_card():
    """On a card: a cell at a reduced frame count and a one-second
    window is correct, through the CUDA kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    workload = CASES[0][0]
    result, _ = harness.run_cell(workload, 2**31 + 3, 1.0, False,
                                 device="cuda",
                                 config_overrides=dict(frames=64))
    assert result["correct"] and result["failed"] == 0
    assert result["device"]["platform"] == "gpu"
