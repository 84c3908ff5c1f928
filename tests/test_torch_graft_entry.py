"""semantic_meshes_torch.graft_entry against the repository's
__graft_entry__.py: the forward step equals the JAX package's, and the
multi-device dry run runs its cases on a gloo world on the CPU."""

import os
import sys
import time

import jax
import numpy as np
import pytest
import torch

from semantic_meshes_torch import graft_entry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _import_jax_entry():
    sys.path.insert(0, REPO)
    try:
        import __graft_entry__ as ge
    finally:
        sys.path.pop(0)
    return ge


def test_entry_equals_the_jax_entry():
    ge = _import_jax_entry()
    jfn, jargs = ge.entry()
    want = np.asarray(jax.jit(jfn)(*jargs))
    fn, args = graft_entry.entry(device="cpu")
    for a, b in zip(args, jargs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    got = fn(*args)
    assert tuple(got.shape) == (300, 19) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-5)
    assert np.abs(want).sum() > 0


@pytest.mark.parametrize("n", [1, 4])
def test_dryrun_multichip_on_a_gloo_world(n):
    """Every case of the dry run on n ranks (views x pixels (2, 2) at 4):
    each rank reports each case equal to the unsharded fusion."""
    logs = graft_entry.dryrun_multichip(n, device="cpu")
    assert len(logs) == n
    pix = 2 if n % 2 == 0 else 1
    for r, log in enumerate(logs):
        assert f"rank {r}: dry run ok" in log, log
        for case in (f"(views, pixels) ({n // pix}, {pix}) weights, "
                     "shard_primitives=True", "texels mul clip_near",
                     "extended lenses on views",
                     f"P = {graft_entry.LARGE_P}"):
            assert f"rank {r}: {case} == unsharded" in log, log


def test_a_failing_rank_fails_the_dry_run_with_its_output(monkeypatch):
    """A rank that raises makes dryrun_multichip raise with that rank's
    output, and the ranks still running are stopped."""
    def command(rank, n, store, device):
        code = (f"import sys, time; print('rank {rank} here', flush=True); "
                f"sys.exit(3) if {rank} == 1 else time.sleep(300)")
        return [sys.executable, "-c", code]

    monkeypatch.setattr(graft_entry, "_rank_command", command)
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 here") as exc:
        graft_entry.dryrun_multichip(3, device="cpu")
    assert "ranks [1] failed" in str(exc.value)
    assert "rc 3" in str(exc.value)
    assert time.monotonic() - t < 60


def test_dryrun_needs_a_card_per_rank(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 cards, have 1"):
        graft_entry.dryrun_multichip(2)


def test_entry_defaults_to_the_card_without_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="is_available"):
        graft_entry.dryrun_multichip(1)
