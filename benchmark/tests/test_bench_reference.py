"""The plain reference held to the program at small sizes on the CPU: the
rasterizer's owners (either backend), the texel mapping and the fusion
arithmetic. Where the two differ, the pixel is fragile and the program's
owner is one of its possible owners."""

import numpy as np
import pytest
import torch

from benchmark import scene
from benchmark.reference import check, fusion, raster, texels
from semantic_meshes_torch import render
from semantic_meshes_torch.distributed import view_accumulate
from semantic_meshes_torch.rasterize import rasterize as program_rasterize

RING = dict(radius=3.0, elevation=0.35, target=[0.0, 0.0, 0.0],
            jitter=dict(angle_steps=0.5, radius=0.02, elevation=0.02,
                        target=0.02))


def small_scene(subdivisions, width=160, height=120, frames=6, seed=7,
                noise=0.0):
    v, f = scene.make_cube(subdivisions)
    if noise:
        rng = np.random.default_rng(seed)
        v = v + rng.uniform(-noise, noise, v.shape).astype(np.float32)
    intrinsics = dict(focal=[0.9 * height] * 2,
                      principal=[width / 2, height / 2])
    cams = scene.trajectory(dict(frames=frames, ring=RING,
                                 intrinsics=intrinsics), seed)
    return torch.tensor(v), torch.tensor(f).long(), [torch.tensor(a)
                                                     for a in cams]


def assert_owners_agree(program_ids, view):
    """Every pixel where the program's owner differs from the reference's
    is fragile, with the program's owner among its possible owners."""
    program_ids = program_ids.reshape(-1).long()
    differ = torch.nonzero(program_ids != view.ids).reshape(-1)
    allowed = set(zip(view.fragile_pix.tolist(), view.fragile_ids.tolist()))
    fragile = set(view.fragile_pix.tolist())
    for p in differ.tolist():
        q = int(program_ids[p])
        assert p in fragile and (q < 0 or (p, q) in allowed), (p, q)
    return differ.numel()


@pytest.mark.parametrize("backend,subdivisions,width,height", [
    ("tile", 5, 160, 120), ("tile", 7, 512, 384), ("dense", 12, 160, 120),
    ("dense", 40, 160, 120)])
def test_raster_owners(backend, subdivisions, width, height):
    v, f, cams = small_scene(subdivisions, width, height)
    fragile = 0
    for k in range(6):
        cam = [a[k] for a in cams]
        ids, _, ov = program_rasterize(v, f, *cam, height=height,
                                       width=width, backend=backend,
                                       device="cpu")
        assert int(ov) == 0
        view = raster.rasterize(v, f, *cam, height=height, width=width)
        assert_owners_agree(ids, view)
        assert (view.ids >= 0).sum() > 1000
        fragile += torch.unique(view.fragile_pix).numel()
    assert fragile < 0.01 * 6 * width * height


def test_raster_blocks_do_not_change_the_result(monkeypatch):
    v, f, cams = small_scene(12)
    cam = [a[2] for a in cams]
    whole = raster.rasterize(v, f, *cam, height=120, width=160)
    monkeypatch.setattr(raster, "MAX_FRAGMENTS", 500)
    blocked = raster.rasterize(v, f, *cam, height=120, width=160)
    assert torch.equal(whole.ids, blocked.ids)
    assert torch.equal(torch.unique(whole.fragile_pix),
                       torch.unique(blocked.fragile_pix))


@pytest.mark.parametrize("tpp,noise", [(0.1, 0.0), (2.0, 0.01)])
def test_texel_mapping(tmp_path, tpp, noise):
    """The program's texel renderer: the same resolutions and texel
    count, and the same texel ids but at fragile pixels. noise moves the
    cube's vertices, so that no corner angles tie (on the cube's
    right-isosceles faces the corner order is a float32 tie, which
    matters only where r > 1)."""
    from semantic_meshes_torch.data import Camera, Ply
    from semantic_meshes_torch.io.ply import write_mesh

    v, f, cams = small_scene(4, 320, 240, noise=noise)
    cameras = [Camera(*(a[k].numpy() for a in cams[:2]), (320, 240),
                      *(a[k].numpy() for a in cams[2:])) for k in range(6)]
    path = tmp_path / "m.ply"
    write_mesh(str(path), v.numpy(), f.int().numpy())
    prog = render.texels(Ply(str(path)), cameras, tpp, device="cpu",
                         bucket=False)
    res, ambiguous = texels.resolutions(v, f, *cams, height=240, width=320,
                                        texels_per_pixel=tpp)
    assert ambiguous == 0
    assert torch.equal(res, prog.resolutions.long())
    first, total = texels.first_texel(res)
    assert total == prog.getPrimitivesNum()
    assert torch.equal(first, prog.first_texel_index.long())
    orders, amb = texels.corner_orders(v, f)
    if noise:
        assert not amb.any()
        assert torch.equal(orders[0], prog.faces.long())
    for k in range(6):
        cam = [a[k] for a in cams]
        ids = prog.render(cameras[k])[0].view(torch.int32).T
        view = texels.shade(
            raster.rasterize(v, f, *cam, height=240, width=320),
            v, orders, res, first, cam, width=320)
        assert_owners_agree(ids, view)
    if tpp > 1:
        assert int(res.max()) > 1


@pytest.mark.parametrize("aggregator", ["sum", "mul"])
def test_fusion_arithmetic(aggregator):
    v, f, cams = small_scene(12)
    cam = [a[1] for a in cams]
    view = raster.rasterize(v, f, *cam, height=120, width=160)
    probs = scene.probability_pool(
        dict(pool_frames=1, height=120, width=160, classes=7), 3, "cpu")[0]
    P = f.shape[0]
    ref, slack = fusion.view_delta(view, probs, aggregator=aggregator,
                                   images_equal_weight=0.5,
                                   num_primitives=P)
    ids = view.ids.reshape(120, 160).to(torch.int32)
    prog = view_accumulate(ids, probs, None, 0.5, P, aggregator)
    assert check.row_gap(prog, ref, torch.zeros_like(slack)) < 1e-6
    control = fusion.control_delta(view, probs, aggregator=aggregator,
                                   images_equal_weight=0.5,
                                   num_primitives=P)
    limit = check.limits()["row_gap"]
    assert check.row_gap(control, ref, slack) > 3 * limit


def test_slack_covers_a_fragile_pixel_given_to_either_owner():
    """One pixel that two owners may take: the reference gives it to
    owner 0; a program that gives it to owner 1 reads no gap."""
    probs = torch.tensor([[[0.25, 0.75], [0.5, 0.5]]], dtype=torch.float32)
    ref_view = raster.ViewRaster(torch.tensor([0, 1]), torch.tensor([0, 0]),
                                 torch.tensor([0, 1]))
    prog_view = raster.ViewRaster(torch.tensor([1, 1]),
                                  torch.tensor([], dtype=torch.int64),
                                  torch.tensor([], dtype=torch.int64))
    kw = dict(aggregator="sum", images_equal_weight=0.5, num_primitives=2)
    ref, slack = fusion.view_delta(ref_view, probs, **kw)
    prog, _ = fusion.view_delta(prog_view, probs, **kw)
    assert check.row_gap(prog, ref, slack) == 0.0
    assert check.row_gap(prog, ref, torch.zeros_like(slack)) > 0.1
