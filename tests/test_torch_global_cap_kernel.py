"""Kernel B (csrc/raster_dense.cu) past the JAX package's global-bucket cap,
on the card: a frame inside the room of the `scannet-room` cell, whose
global bucket holds more than N_GLOBAL big rows, resolved at n_global 4096
equals the plain version bit for bit. Marked `gpu`; without a card it
skips. Run on the card with

    python -m pytest -m gpu tests/test_torch_global_cap_kernel.py
"""

import numpy as np
import pytest
import torch

from semantic_meshes_torch import testing
from semantic_meshes_torch.data import Camera
from semantic_meshes_torch.rasterize import dense, dense_kernel

pytestmark = pytest.mark.gpu

# ScanNet v2's colour camera and the room cell's INDOOR_RING pose
WIDTH, HEIGHT = 1296, 968
FOCAL, PRINCIPAL = 1170.187988, (647.75, 483.75)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90a): the kernels have no CPU "
                    "mode; their plain versions are tested on the CPU")
    return torch.device("cuda", 0)


def _room_frame():
    """The 4 m room of 99372 triangles and the ring view at 45 degrees,
    the one of 16 with the largest global bucket (1722 big rows)."""
    v, f = testing.make_cube(91, size=4.0)
    ring = testing.make_ring_cameras(16, WIDTH, HEIGHT, radius=0.8,
                                     elevation=-0.625, focal=FOCAL,
                                     target=(0.0, -0.9, 0.0))[2]
    cam = Camera(ring.rotation, ring.translation, (WIDTH, HEIGHT),
                 [FOCAL, FOCAL], PRINCIPAL)
    return v, f, cam


def test_raster_dense_past_the_jax_cap_matches_plain(cuda):
    v, f, cam = _room_frame()
    fv = torch.as_tensor(v, device=cuda)[torch.as_tensor(
        f.astype(np.int64), device=cuda)]
    kw = dict(face_vertices=fv, height=HEIGHT, width=WIDTH, device=cuda)
    pairs, micro, big = dense.candidate_stats(
        None, None, cam.rotation, cam.translation, cam.focal_lengths,
        cam.principal_point, **kw).tolist()
    args, _, overflow = dense.resolve_inputs(
        None, None, cam.rotation, cam.translation, cam.focal_lengths,
        cam.principal_point, n_global=4096, e_cap_rows=2 * pairs,
        micro_cap_rows=2 * micro, **kw)
    starts = args[2]
    B = starts.numel() - 2
    bucket = int(starts[B + 1] - starts[B])
    assert int(overflow) == 0
    assert bucket == big and dense.N_GLOBAL < bucket < 4096
    z, ids = dense_kernel.resolve_dense_cuda(*args)
    zp, ip = dense_kernel.resolve_dense_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(ids, ip)
    assert torch.equal(z.view(torch.int32), zp.view(torch.int32))
    assert bool((ids >= 0).all())  # a closed room leaves no background
