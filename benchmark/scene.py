"""The scene of a cell, made from its configuration and `--seed` alone.

The mesh is `semantic_meshes_torch.testing.make_cube` and the trajectory
a ring of poses as `make_ring_cameras` places them, copied here so that
the program cannot move them: a cube of 12 s^2 triangles and `frames`
pinhole poses on a ring, each pose jittered from the seed, at the
intrinsics the configuration states. The probabilities are
a pool of softmaxed normal logits made on the device from the seed; frame
i reads pool slot i mod `pool_frames`. The same seed gives the same scene.
"""

from __future__ import annotations

import numpy as np
import torch


def make_cube(subdivisions, size=1.0):
    """(vertices (V, 3) f32, faces (T, 3) int32) of an axis-aligned cube
    centred at the origin, each side an s x s grid of quads cut in two:
    T = 12 s^2. The vertices, their order and every rounding are those
    of `semantic_meshes_torch.testing.make_cube`."""
    s = int(subdivisions)
    half = size / 2.0
    frames = [
        ([-half, -half, half], [size, 0, 0], [0, size, 0]),
        ([half, -half, -half], [-size, 0, 0], [0, size, 0]),
        ([half, -half, half], [0, 0, -size], [0, size, 0]),
        ([-half, -half, -half], [0, 0, size], [0, size, 0]),
        ([-half, half, half], [size, 0, 0], [0, 0, -size]),
        ([-half, -half, -half], [size, 0, 0], [0, 0, size]),
    ]
    steps = np.arange(s + 1) / s
    jj, ii = np.meshgrid(steps, steps, indexing="ij")
    grid = np.arange((s + 1) ** 2).reshape(s + 1, s + 1)
    a = grid[:-1, :-1].reshape(-1)
    b, c = a + 1, a + (s + 1)
    d = c + 1
    quad = np.stack([np.stack([a, b, d], -1), np.stack([a, d, c], -1)],
                    1).reshape(-1, 3)
    verts, faces = [], []
    for k, (origin, u, v) in enumerate(frames):
        origin, u, v = (np.asarray(x, np.float64) for x in (origin, u, v))
        verts.append(origin + u * ii.reshape(-1, 1) + v * jj.reshape(-1, 1))
        faces.append(quad + k * (s + 1) ** 2)
    return (np.concatenate(verts).astype(np.float32),
            np.concatenate(faces).astype(np.int32))


def look_at(eye, target, up):
    """World->camera (rotation, translation), f32, the camera looking down
    +z (`semantic_meshes_torch.geometry.look_at`)."""
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    up = np.asarray(up, np.float64)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    rotation = np.stack([right, down, fwd], axis=0)
    translation = -rotation @ eye
    return rotation.astype(np.float32), translation.astype(np.float32)


def trajectory(config, seed):
    """The (rotations (F, 3, 3), translations (F, 3), focal lengths (F, 2),
    principal points (F, 2)) f32 numpy arrays of the configuration's
    `frames` poses. `ring` gives the radius, the eye's height as a share
    of the radius, the look-at `target` and the `jitter`: pose k at angle
    2 pi k / F, each angle, radius, height and target jittered uniformly
    from the seed. `intrinsics` gives the focal lengths and principal
    point in pixels, the same for every frame."""
    ring = config["ring"]
    jit = ring["jitter"]
    n = int(config["frames"])
    rng = np.random.default_rng([abs(int(seed)), 0])
    step = 2 * np.pi / n
    ang = step * np.arange(n) + step * rng.uniform(-jit["angle_steps"],
                                                   jit["angle_steps"], n)
    radius = ring["radius"] * (1 + rng.uniform(-jit["radius"],
                                               jit["radius"], n))
    elev = ring["elevation"] + rng.uniform(-jit["elevation"],
                                           jit["elevation"], n)
    target = np.asarray(ring["target"], np.float64) + rng.uniform(
        -jit["target"], jit["target"], (n, 3))
    rot = np.empty((n, 3, 3), np.float32)
    trans = np.empty((n, 3), np.float32)
    for k in range(n):
        eye = [radius[k] * np.cos(ang[k]), elev[k] * radius[k],
               radius[k] * np.sin(ang[k])]
        rot[k], trans[k] = look_at(eye, target[k], [0, 1, 0])
    intr = config["intrinsics"]
    fl = np.tile(np.asarray(intr["focal"], np.float32), (n, 1))
    pp = np.tile(np.asarray(intr["principal"], np.float32), (n, 1))
    return rot, trans, fl, pp


def probability_pool(config, seed, device):
    """(pool_frames, H, W, C) f32 softmax probabilities of normal logits,
    made on `device` from the seed, one slot a call."""
    n = int(config["pool_frames"])
    shape = (int(config["height"]), int(config["width"]),
             int(config["classes"]))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**64)
    pool = torch.empty((n,) + shape, dtype=torch.float32, device=device)
    for i in range(n):
        torch.randn(shape, generator=gen, device=device, out=pool[i])
        pool[i] = torch.softmax(pool[i], dim=-1)
    return pool
