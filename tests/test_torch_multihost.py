"""semantic_meshes_torch.distributed.initialize_multihost across separate
python processes. Mirrors tests/test_multihost.py: two processes join
one gloo world through a localhost TCP rendezvous
(coordinator_address="127.0.0.1:<free port>"), run make_sharded_fuse on
a (2, 1) mesh and on a (1, 1, 2) faces mesh, and each holds a replica
equal to the single-process fuse_views; a world of one process equals
fuse_views bit for bit. A CUDA request on a machine without a card
raises (no gloo fallback)."""

import socket

import numpy as np
import pytest
import torch

import _torch_sharded as ts
from semantic_meshes import distributed as jdist
from semantic_meshes import testing as jtesting
from semantic_meshes.data import stack_cameras
from semantic_meshes_torch import distributed

H, W, C = 64, 128, 5
ARGS = ("vertices", "faces", "rot", "trans", "fl", "pp", "probs", "iew")


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def scene():
    """tests/test_multihost.py's scene: cube s=4, 4 views of 128x64."""
    vertices, faces = jtesting.make_cube(subdivisions=4)
    cams = jtesting.make_ring_cameras(num_views=4, width=W, height=H)
    rng = np.random.default_rng(0)
    probs = np.stack([jtesting.random_probs(rng, H, W, C) for _ in cams])
    rot, trans, fl, pp = stack_cameras(cams)
    return dict(vertices=vertices, faces=faces, rot=rot, trans=trans, fl=fl,
                pp=pp, probs=probs, iew=np.float32(0.5))


INPUTS = scene()
KW = dict(num_primitives=len(INPUTS["faces"]), aggregator="sum", height=H,
          width=W)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp2 = tmp_path_factory.mktemp("multihost")
    np.savez(tmp2 / "in.npz", **INPUTS)
    w2 = ts.World(tmp2, [
        ts.case("views", (2, 1), tmp2 / "in.npz", ARGS, **KW),
        ts.case("faces", (1, 1, 2), tmp2 / "in.npz", ARGS, **KW)],
        n=2, store=f"127.0.0.1:{free_port()}")
    tmp1 = tmp_path_factory.mktemp("world_of_one")
    np.savez(tmp1 / "in.npz", **INPUTS)
    w1 = ts.World(tmp1, [ts.case("one", (1, 1), tmp1 / "in.npz", ARGS,
                                 **KW)], n=1)
    yield {2: w2, 1: w1}
    w2.close()
    w1.close()


def one_process():
    acc, ov = distributed.fuse_views(*(INPUTS[k] for k in ARGS),
                                     device="cpu", **KW)
    assert int(ov) == 0
    return acc.numpy()


@pytest.mark.parametrize("name", ["views", "faces"])
def test_two_process_fuse_matches_single_process(worlds, name):
    acc, ov = worlds[2].replicated(name)  # equal replicas on both ranks
    assert ov == 0 and np.abs(acc).sum() > 0
    np.testing.assert_allclose(acc, one_process(), rtol=2e-5, atol=1e-5)
    ref = np.asarray(jdist.fuse_views(*(INPUTS[k] for k in ARGS), **KW)[0])
    np.testing.assert_allclose(acc, ref, rtol=2e-5, atol=1e-5)


def test_world_of_one_is_fuse_views_bit_for_bit(worlds):
    """Every collective of a (1, 1) mesh is over one rank (skipped), so
    the sharded fuse is fuse_views op for op."""
    acc, ov = worlds[1].replicated("one")
    assert ov == 0
    np.testing.assert_array_equal(acc, one_process())
    assert all(c["skipped"] for c in worlds[1].collectives("one"))


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="is_available"):
        distributed.initialize_multihost("127.0.0.1:1", 1, 0)
    with pytest.raises(RuntimeError, match="is_available"):
        distributed.make_device_mesh()
    assert not torch.distributed.is_initialized()
