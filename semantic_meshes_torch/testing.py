"""Synthetic scenes for tests, the chip smoke run and benchmarks.

Counterpart of `make_cube`, `make_ring_cameras`, `random_probs` and the
fake ScanNet scene (`write_scannet_label_tsv`, `_write_labeled_cube_ply`,
`build_synthetic_scannet_scene`) in `semantic_meshes/testing.py` (numpy
only, so both packages build the very same scene from the same
arguments): a subdivided cube viewed by pinhole cameras on a ring, fused
with random class probabilities. The port's own
`dense_resolve_scene` and `tile_resolve_scene` build inputs of the two
z-resolve kernels directly in screen space.
"""

from __future__ import annotations

import numpy as np

from .data import Camera
from .geometry import look_at


def make_cube(subdivisions=9, size=1.0):
    """Axis-aligned cube centered at origin, each face an s x s quad grid.

    Returns (vertices (V, 3) f32, faces (T, 3) i32) with
    T = 12 * subdivisions**2 (s=9 -> 972 triangles).
    """
    s = int(subdivisions)
    half = size / 2.0
    verts = []
    faces = []
    # each face: origin corner, u axis, v axis
    face_frames = [
        ([-half, -half, half], [size, 0, 0], [0, size, 0]),   # +z
        ([half, -half, -half], [-size, 0, 0], [0, size, 0]),  # -z
        ([half, -half, half], [0, 0, -size], [0, size, 0]),   # +x
        ([-half, -half, -half], [0, 0, size], [0, size, 0]),  # -x
        ([-half, half, half], [size, 0, 0], [0, 0, -size]),   # +y
        ([-half, -half, -half], [size, 0, 0], [0, 0, size]),  # -y
    ]
    for origin, u, v in face_frames:
        base = len(verts)
        origin, u, v = np.asarray(origin), np.asarray(u), np.asarray(v)
        for j in range(s + 1):
            for i in range(s + 1):
                verts.append(origin + u * (i / s) + v * (j / s))
        for j in range(s):
            for i in range(s):
                a = base + j * (s + 1) + i
                b = a + 1
                c = a + (s + 1)
                d = c + 1
                faces.append([a, b, d])
                faces.append([a, d, c])
    return (
        np.asarray(verts, np.float32),
        np.asarray(faces, np.int32),
    )


def make_ring_cameras(num_views=4, width=256, height=192, radius=3.0,
                      elevation=0.35, focal=None, target=(0, 0, 0)):
    """Cameras on a horizontal ring looking at `target`."""
    if focal is None:
        focal = 0.9 * min(width, height)
    cams = []
    for k in range(num_views):
        ang = 2 * np.pi * k / num_views
        eye = np.array(
            [radius * np.cos(ang), elevation * radius, radius * np.sin(ang)]
        )
        rotation, translation = look_at(eye, target, [0, 1, 0])
        cams.append(
            Camera(
                rotation,
                translation,
                np.array([width, height]),
                np.array([focal, focal], np.float32),
                np.array([width / 2, height / 2], np.float32),
            )
        )
    return cams


def write_scannet_label_tsv(path, num_classes=6):
    """Minimal scannetv2-labels.combined.tsv: identity raw->nyu40 mapping
    for ids 1..num_classes (schema per the real TSV's columns used by the
    eval harness)."""
    with open(path, "w") as f:
        f.write("id\traw_category\tcategory\tnyu40id\n")
        for i in range(1, num_classes + 1):
            f.write(f"{i}\tc{i}\tc{i}\t{i}\n")


def _write_labeled_cube_ply(path, subdivisions):
    """Write a ScanNet-style labeled cube mesh (vertex x/y/z + ushort
    label, int32 face lists). Returns (vertices, faces, face_class_nyu)."""
    vertices, faces = make_cube(subdivisions=subdivisions)
    tris_per_side = len(faces) // 6
    face_class_nyu = (np.arange(len(faces)) // tris_per_side) + 1  # 1..6

    vertex_labels = np.zeros(len(vertices), np.int64)
    for f, cls in zip(faces, face_class_nyu):
        vertex_labels[f] = cls

    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {len(vertices)}\n".encode())
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        f.write(b"property ushort label\n")
        f.write(f"element face {len(faces)}\n".encode())
        f.write(b"property list uchar int vertex_indices\nend_header\n")
        rec = np.empty(
            len(vertices),
            dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("l", "<u2")],
        )
        rec["x"], rec["y"], rec["z"] = vertices.T
        rec["l"] = vertex_labels
        f.write(rec.tobytes())
        frec = np.empty(len(faces), dtype=[("n", "u1"), ("i", "<i4", (3,))])
        frec["n"] = 3
        frec["i"] = faces
        f.write(frec.tobytes())
    return vertices, faces, face_class_nyu


def build_synthetic_scannet_scene(root, name, *, subdivisions=3,
                                  num_views=4, width=128, height=96,
                                  classes=40, radius=3.0,
                                  write_probs=True, renderer=None,
                                  prob_noise=0.0, noise_seed=0,
                                  simplify_factors=(), device="cpu"):
    """Build a fake ScanNet scene directory for eval tests/benchmarks.

    Counterpart of the JAX package's `testing.build_synthetic_scannet_
    scene`, the same files from the same arguments. Creates
    scans/<name>/ with <name>_vh_clean_2.labels.ply (cube mesh,
    per-vertex raw labels 1..6 by cube side), <name>.sens (posed frames
    with jpeg color + zlib depth), label-filt/<i>.png ground truth, and
    (optionally) probs/<name>/<i>.npy one-hot predictions.

    prob_noise > 0 makes the written predictions imperfect (so fusion has
    something to fix): per covered pixel, the label is flipped to a
    random class with probability prob_noise * frame_index /
    (num_views - 1) (later frames are noisier, so per-image vs per-pixel
    weighting genuinely differ), then every distribution is smoothed with
    30% uniform mass (so the mul aggregator sees graded confidences).
    Deterministic via noise_seed.

    simplify_factors: iterable of STRINGS (e.g. ("0.25",)); for each, a
    coarser cube (~factor x the faces) is written under the
    `_vh_clean_2.labels_simplified-<factor>.ply` name the eval resolves
    for --simplify <factor>.

    Returns (num_faces, num_views). The gt label images are rendered by
    `renderer`, or by a port TrianglesRenderer on `device` (the CPU by
    default). imageio writes the PNGs and JPEGs.
    """
    import io
    import os
    import zlib

    import imageio.v2 as imageio

    from . import data as sm_data
    from . import render as sm_render
    from .data2.scannet import write_sens

    root = os.fspath(root)
    scene = os.path.join(root, "scans", name)
    os.makedirs(os.path.join(scene, "label-filt"), exist_ok=True)

    W, H = int(width), int(height)
    ply_path = os.path.join(scene, f"{name}_vh_clean_2.labels.ply")
    vertices, faces, face_class_nyu = _write_labeled_cube_ply(
        ply_path, subdivisions)
    for factor in simplify_factors:
        # a coarser cube stands in for meshlab's quadric decimation: same
        # geometry, ~factor x the face count
        sub = max(1, round(subdivisions * float(factor) ** 0.5))
        _write_labeled_cube_ply(
            os.path.join(
                scene,
                f"{name}_vh_clean_2.labels_simplified-{factor}.ply",
            ),
            sub,
        )

    cams = make_ring_cameras(num_views=num_views, width=W, height=H,
                             radius=radius)
    if renderer is None:
        renderer = sm_render.triangles(sm_data.Ply(ply_path), device=device)

    fx = fy = 0.9 * min(W, H)
    intrinsic = np.eye(4, dtype=np.float32)
    intrinsic[0, 0], intrinsic[1, 1] = fx, fy
    intrinsic[0, 2], intrinsic[1, 2] = W / 2, H / 2

    probs_dir = os.path.join(root, "probs", name)
    if write_probs:
        os.makedirs(probs_dir, exist_ok=True)
    noise_rng = np.random.default_rng(noise_seed)

    frames = []
    for i, cam in enumerate(cams):
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = cam.rotation
        w2c[:3, 3] = cam.translation
        c2w = np.linalg.inv(w2c)

        idx, _ = renderer.render(cam)
        idx_hw = idx.cpu().numpy().T
        covered = idx_hw != 0xFFFFFFFF
        gt = np.zeros((H, W), np.uint16)
        gt[covered] = face_class_nyu[idx_hw[covered].astype(np.int64)]
        imageio.imwrite(
            os.path.join(scene, "label-filt", f"{i}.png"), gt
        )

        if write_probs:
            probs = np.zeros((H, W, classes), np.float32)
            ys, xs = np.nonzero(covered)
            labels = gt[covered].astype(np.int64) - 1
            if prob_noise > 0:
                frame_noise = prob_noise * (
                    i / max(num_views - 1, 1)
                )
                flip = noise_rng.random(len(labels)) < frame_noise
                labels = np.where(
                    flip,
                    noise_rng.integers(0, classes, size=len(labels)),
                    labels,
                )
            probs[ys, xs, labels] = 1.0
            if prob_noise > 0:
                # 30% uniform smoothing: graded confidences for "mul"
                probs[ys, xs] = 0.7 * probs[ys, xs] + 0.3 / classes
            np.save(os.path.join(probs_dir, f"{i}.npy"), probs)

        color = np.zeros((H, W, 3), np.uint8)
        color[covered] = 128
        depth = np.full((H, W), 1000, np.uint16)
        buf = io.BytesIO()
        imageio.imwrite(buf, color, format="jpeg")
        frames.append(
            dict(
                camera_to_world=c2w,
                timestamp_color=i,
                timestamp_depth=i,
                color_data=buf.getvalue(),
                depth_data=zlib.compress(depth.tobytes()),
            )
        )

    write_sens(
        os.path.join(scene, f"{name}.sens"),
        "synthetic",
        intrinsic, np.eye(4, dtype=np.float32),
        intrinsic, np.eye(4, dtype=np.float32),
        color_hw=(H, W), depth_hw=(H, W), depth_shift=1000.0,
        frames=frames,
    )
    return len(faces), num_views


def random_probs(rng, height, width, classes, dont_care_frac=0.0):
    """Random softmax class-probability image (H, W, C) float32."""
    logits = rng.normal(size=(height, width, classes)).astype(np.float32)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    probs = e / e.sum(-1, keepdims=True)
    if dont_care_frac > 0:
        dc = rng.random((height, width)) < dont_care_frac
        probs[dc] = 0.0
    return probs


# hand-binned scenes of dense_resolve_scene: work-item boundaries (a tile
# of ITEM - 1, ITEM, ITEM + 1 and 3 ITEM + 5 candidates), exact depth ties
# across items and between a global and an own candidate, global buckets
# over ITEM long (clamped or dropped by n_global), empty tiles, slivers and
# far-off-screen or overflowing vertices, and an image of 1100 tiles (the
# kernel maps items to tiles through windows of 1024 tiles)
DENSE_SCENES = ("items", "tie_items", "tie_global", "global_big",
                "global_clamped", "no_global", "slivers", "many_tiles")


def _screen_tris(rng, n, box, size, z=(2.0, 10.0)):
    """n random triangles (vertices (n, 3, 2), depths (n, 3)) with centres
    in box = (x0, y0, x1, y1) and vertex offsets up to `size` pixels."""
    x0, y0, x1, y1 = box
    c = rng.uniform([x0, y0], [x1, y1], size=(n, 2))
    p = c[:, None, :] + rng.uniform(-size, size, size=(n, 3, 2))
    return p, rng.uniform(*z, size=(n, 3))


def _adversarial_tris(rng, n, box):
    """Slivers, sub-pixel triangles, collinear ones, and triangles with
    vertices far off screen or large enough to overflow the edge forms."""
    p, z = _screen_tris(rng, n, box, 6.0)
    kind = rng.integers(0, 5, size=n)
    far = rng.choice([1e4, 1e7, 1e20, 1e30], size=(n, 2))
    far *= rng.choice([-1.0, 1.0], size=(n, 2))
    for i in range(n):
        if kind[i] == 0:  # sliver: the third vertex 1e-3 px off the edge
            p[i, 2] = (p[i, 0] + p[i, 1]) / 2 + 1e-3
        elif kind[i] == 1:  # sub-pixel
            p[i, 1:] = p[i, 0] + rng.uniform(-0.4, 0.4, size=(2, 2))
        elif kind[i] == 2:  # collinear (zero area)
            p[i, 2] = 2 * p[i, 1] - p[i, 0]
        elif kind[i] == 3:  # one vertex far off screen
            p[i, rng.integers(0, 3)] = far[i]
    return p, z


def dense_resolve_scene(name, device="cpu"):
    """resolve_dense arguments (table, sorted_ids, starts, n_global,
    micro_key, y_offset, nbx, height, width) of the hand-binned scene
    `name` (one of DENSE_SCENES), made from a seed. Tile lists hold ids in
    ascending order with the global bucket after them, as the sort binning
    leaves them; a triangle listed in a tile need not cover it."""
    import torch

    from .rasterize import dense, dense_kernel, tile_kernel, tiles

    K = dense_kernel.ITEM
    rng = np.random.default_rng(sum(map(ord, name)))
    n_global, y_offset, micro = dense.N_GLOBAL, 0.0, False
    width, height = 256, 48
    glob = None
    if name == "items":
        counts, micro = [K - 1, K, K + 1, 3 * K + 5, 0, 7], True
        glob = _screen_tris(rng, 3, (0, 0, width, height), 80.0)
    elif name == "tie_items":
        width, height, counts = 128, 16, [2 * K + 10]
    elif name == "tie_global":
        counts = [K + 50, 3, 0, 0, 0, 9]
    elif name in ("global_big", "global_clamped", "no_global"):
        width, height, y_offset, micro = 384, 48, 7.0, True
        counts = [5, 0, 40, 0, 300, 1, 0, 0, 17]
        glob = _screen_tris(rng, K + 37, (0, 7, width, height + 7), 60.0)
        n_global = {"global_big": n_global, "global_clamped": K + 3,
                    "no_global": 0}[name]
    elif name == "slivers":
        width, height, counts = 256, 32, [600, 20, 0, 0]
        glob = _adversarial_tris(rng, 2, (0, 0, width, height))
    elif name == "many_tiles":  # one column of 1100 tiles
        width, height = 128, 1100 * dense_kernel.TILE_H
        counts = [0] * 1100
        for b, n in ((0, 3), (700, K + 1), (1023, K), (1024, 1),
                     (1050, K + 6), (1099, 5)):
            counts[b] = n
        glob = _screen_tris(rng, 2, (0, 0, width, height), 90.0)
    else:
        raise KeyError(name)
    nbx = -(-width // dense_kernel.TILE_W)
    ps, zs = [], []
    for b, n in enumerate(counts):
        ty, tx = divmod(b, nbx)
        box = (tx * dense_kernel.TILE_W, ty * dense_kernel.TILE_H + y_offset,
               (tx + 1) * dense_kernel.TILE_W,
               (ty + 1) * dense_kernel.TILE_H + y_offset)
        if name == "slivers":
            p, z = _adversarial_tris(rng, n, box)
        else:
            p, z = _screen_tris(rng, n, box, 12.0)
        if name == "tie_items":  # three copies of one nearest triangle
            for i in (3, K + 20, 2 * K + 5):
                p[i] = [[10, 1], [120, 4], [40, 15]]
                z[i] = 1.0
        if name == "tie_global" and b == 0:  # copies of the global one
            for i in (0, K + 10):
                p[i] = [[5, 2], [100, 6], [20, 14]]
                z[i] = 1.5
        ps.append(p)
        zs.append(z)
    if name == "tie_global":
        glob = (np.array([[[5, 2], [100, 6], [20, 14]],
                          [[0, 0], [256, 0], [0, 48]]], np.float64),
                np.array([[1.5] * 3, [9.0] * 3]))
    if glob is not None:
        ps.append(glob[0])
        zs.append(glob[1])
    setup = tiles._setup_from_projected(
        torch.as_tensor(np.concatenate(ps), dtype=torch.float32),
        torch.as_tensor(np.concatenate(zs), dtype=torch.float32))
    table = tile_kernel.candidate_table(setup).to(device)
    T = table.shape[0] - 1
    own = int(sum(counts))
    starts = np.concatenate([[0], np.cumsum(counts), [T]]).astype(np.int32)
    assert starts[-2] == own
    key = None
    if micro:  # a sparse micro-fragment image to merge
        hit = rng.random((height, width)) < 0.05
        zbits = np.float32(rng.uniform(1.5, 9.0, size=(height, width)))
        packed = (zbits.view(np.int32).astype(np.int64) << 32) | \
            rng.integers(0, T, size=(height, width))
        key = torch.as_tensor(np.where(hit, packed, dense_kernel.BG_KEY),
                              device=device)
    return (table, torch.arange(T, dtype=torch.int32, device=device),
            torch.as_tensor(starts, device=device), n_global, key, y_offset,
            nbx, height, width)


# scenes of tile_resolve_scene, for the tile z-resolve's (32, 128) tiles of
# 16 x 8 warp rectangles: a tile over the 256-candidate cap, slivers along
# the rectangles' boundaries (with far-off-screen and overflowing
# vertices), exact depth ties inside one rectangle and across two (with
# permuted ids, so the earlier list position wins, not the smaller id), a
# ragged right and bottom edge, a y_offset row band, and an all-empty view
TILE_SCENES = ("cap", "slivers", "ties", "ragged", "band", "empty")


def _slivers(rng, n, box, col_step=16, row_step=8):
    """n thin triangles lying along the lines x = k * col_step and y = k *
    row_step inside box = (x0, y0, x1, y1), each a fraction of a pixel
    wide."""
    x0, y0, x1, y1 = box
    p = np.zeros((n, 3, 2))
    for i in range(n):
        along = rng.uniform(5.0, 60.0)
        width = rng.uniform(0.05, 0.9)
        if i % 2:  # vertical, on a column boundary
            x = col_step * rng.integers(1, max(2, (x1 - x0) // col_step)) + x0
            y = rng.uniform(y0, y1)
            p[i] = [[x - width / 2, y], [x + width / 2, y + 0.3],
                    [x, y + along]]
        else:  # horizontal, on a row boundary
            y = row_step * rng.integers(1, max(2, (y1 - y0) // row_step)) + y0
            x = rng.uniform(x0, x1)
            p[i] = [[x, y - width / 2], [x + along, y], [x + 0.2,
                                                         y + width / 2]]
    return p, rng.uniform(2.0, 10.0, size=(n, 3))


def tile_resolve_scene(name, device="cpu"):
    """resolve_tiles arguments (table, cand, counts, y_offset, nbx, height,
    width) of scene `name` (one of TILE_SCENES), made from a seed: screen
    triangles binned by tiles._bin_triangles at the 256-candidate cap."""
    import torch

    from .rasterize import tile_kernel, tiles

    rng = np.random.default_rng(sum(map(ord, name)))
    width, height, y_offset = 256, 64, 0.0
    parts = []
    tri_ids = None
    if name == "cap":  # tile 0 lists 256 of its ~300 triangles
        parts += [_screen_tris(rng, 300, (4, 4, 124, 28), 6.0),
                  _screen_tris(rng, 60, (0, 0, width, height), 40.0)]
    elif name == "slivers":
        parts += [_slivers(rng, 120, (0, 0, width, height)),
                  _adversarial_tris(rng, 60, (0, 0, width, height)),
                  _screen_tris(rng, 20, (0, 0, width, height), 30.0)]
    elif name == "ties":  # copies of one triangle inside one rectangle and
        # of one across two rectangles (and a band boundary), each copy
        # listed at several positions
        one = np.array([[[2, 1], [13, 2], [5, 6]]], np.float64)
        two = np.array([[[10, 10], [40, 12], [20, 25]]], np.float64)
        other, oz = _screen_tris(rng, 40, (0, 0, width, height), 25.0)
        p = np.concatenate([one, other[:10], two, one, other[10:30], two,
                            one, other[30:]])
        z = np.concatenate([[[3.0] * 3], oz[:10], [[2.5, 3.0, 3.5]],
                            [[3.0] * 3], oz[10:30], [[2.5, 3.0, 3.5]],
                            [[3.0] * 3], oz[30:]])
        parts.append((p, z))
        # the earlier copies get the larger ids
        tri_ids = np.arange(len(p), dtype=np.int32)[::-1].copy()
    elif name == "ragged":
        width, height = 300, 75
        parts += [_screen_tris(rng, 150, (0, 0, width, height), 25.0),
                  _slivers(rng, 30, (0, 0, width, height))]
    elif name == "band":  # rows [37, 85) of a taller image
        width, height, y_offset = 256, 48, 37.0
        parts += [_screen_tris(rng, 120, (0, 20, width, 100), 25.0),
                  _slivers(rng, 30, (0, 37, width, 85))]
    elif name == "empty":  # every triangle off screen or behind the camera
        p, z = _screen_tris(rng, 40, (-900, -900, -300, -300), 20.0)
        p2, z2 = _screen_tris(rng, 10, (0, 0, width, height), 20.0)
        parts += [(p, z), (p2, -z2)]
    else:
        raise KeyError(name)
    p = np.concatenate([q for q, _ in parts])
    z = np.concatenate([q for _, q in parts])
    setup = tiles._setup_from_projected(
        torch.as_tensor(p, dtype=torch.float32),
        torch.as_tensor(z, dtype=torch.float32))
    cand, counts, _ = tiles._bin_triangles(setup, height, width, 256,
                                           y_offset)
    table = tile_kernel.candidate_table(setup, tri_ids)
    return (table.to(device), cand.to(device), counts.to(device), y_offset,
            tiles._cdiv(width, tiles.TILE_W), height, width)
