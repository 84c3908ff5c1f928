"""Shared pieces of the tests/test_torch_scripts_*.py and
tests/test_torch_eval_drivers.py mirrors: tests/test_scripts.py's fixture
scene built by the port, JAX script runs as background processes (each
started once per module fixture and compared with every port case), and
PLY / PNG readers.

The port's scripts run in-process through `main(argv)` with
`--device cpu`.
"""

import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUB = os.path.join(REPO, "tests", "_tfcv_stub")
W, H, C = 128, 96, 19

# (camera model, lens wire) of tests/test_scripts.py's distorted cases
DISTORTED = {
    "simple_radial": ("SIMPLE_RADIAL", np.array([0.08, 0, 0, 0])),
    "opencv_fisheye": (
        "OPENCV_FISHEYE",
        np.array([0.03, -0.011, 0.002, -0.0005, 0, 0, 0, 0, 1.0])),
    "thin_prism_fisheye": (
        "THIN_PRISM_FISHEYE",
        np.array([0.03, -0.011, 0.002, -0.0015, 0.0008, -0.0002, 0.001,
                  -0.0007, 3.0])),
}


def rot_to_quat(m):
    w = np.sqrt(max(0, 1 + m[0, 0] + m[1, 1] + m[2, 2])) / 2
    return np.array(
        [w, (m[2, 1] - m[1, 2]) / (4 * w), (m[0, 2] - m[2, 0]) / (4 * w),
         (m[1, 0] - m[0, 1]) / (4 * w)])


def write_workspace(ws, cams, cam_model="PINHOLE", dist=None):
    from semantic_meshes_torch.io import colmap as cio

    os.makedirs(ws, exist_ok=True)
    cameras = {1: cio.ColmapCamera(
        1, cam_model, W, H, np.array([0.9 * H, 0.9 * H]),
        np.array([W / 2, H / 2]), dist)}
    images = {i: cio.ColmapImage(
        i, rot_to_quat(np.asarray(c.rotation, np.float64)),
        np.asarray(c.translation, np.float64), 1, f"v{i}.png")
        for i, c in enumerate(cams, 1)}
    cio.write_cameras_txt(os.path.join(ws, "cameras.txt"), cameras)
    cio.write_images_txt(os.path.join(ws, "images.txt"), images)


def build_scene(root, cam_model="PINHOLE", dist=None):
    """tests/test_scripts.py's scene, built by the port on the CPU: cube
    s=4 (384 triangles), 3 ring views of 128x96 in a COLMAP text
    workspace root/ws, a known class per triangle ((i * 7) % 19),
    one-hot 19-class maps root/probs/v<i>.npy and images root/images
    (120 where covered). Returns (tri_class, {view: (covered (H, W),
    class image (H, W) uint8)})."""
    import torch

    from semantic_meshes_torch import data, render, testing
    from semantic_meshes_torch.io.image import imwrite
    from semantic_meshes_torch.io.ply import write_mesh

    root = str(root)
    vertices, faces = testing.make_cube(4)
    os.makedirs(root, exist_ok=True)
    write_mesh(os.path.join(root, "mesh.ply"), vertices, faces)
    cams = testing.make_ring_cameras(num_views=3, width=W, height=H)
    write_workspace(os.path.join(root, "ws"), cams, cam_model, dist)
    renderer = render.triangles(data.Ply(os.path.join(root, "mesh.ply")),
                                device="cpu")
    tri_class = (np.arange(renderer.getPrimitivesNum()) * 7) % C
    workspace = data.Colmap(os.path.join(root, "ws"))
    os.makedirs(os.path.join(root, "images"))
    os.makedirs(os.path.join(root, "probs"))
    views = {}
    for i in range(1, 4):
        ids, _ = renderer.render(workspace.getCamera(f"v{i}.png"))
        ids_hw = ids.view(torch.int32).numpy().T.astype(np.int64)
        cov = ids_hw >= 0
        probs = np.zeros((H, W, C), np.float32)
        ys, xs = np.nonzero(cov)
        probs[ys, xs, tri_class[ids_hw[cov]]] = 1.0
        np.save(os.path.join(root, "probs", f"v{i}.npy"), probs)
        img = np.zeros((H, W, 3), np.uint8)
        img[cov] = 120
        imwrite(os.path.join(root, "images", f"v{i}.png"), img)
        cls = np.zeros((H, W), np.uint8)
        cls[cov] = tri_class[ids_hw[cov]]
        views[i] = (cov, cls)
    return tri_class, views


def jax_env(extra_path=None):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["SM_PLATFORM"] = "cpu"
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (extra_path, REPO, env.get("PYTHONPATH")) if p)
    return env


class Background:
    """A process started now and read later; `.wait()` asserts rc 0 and
    returns its stdout."""

    def __init__(self, cmd, log, env=None, cwd=None):
        self.cmd, self.log = cmd, str(log)
        self._out = open(self.log, "w")
        self.proc = subprocess.Popen(cmd, env=env or jax_env(), cwd=cwd,
                                     stdout=self._out,
                                     stderr=subprocess.STDOUT, text=True)

    def wait(self, timeout=600):
        rc = self.proc.wait(timeout=timeout)
        self._out.close()
        with open(self.log) as f:
            out = f.read()
        assert rc == 0, f"{self.cmd}\n{out[-4000:]}"
        return out


def jax_script(name, args, log, env=None):
    """Start the JAX repository's script `name` (scripts/ or
    eval-scannet/) in the background."""
    for folder in ("scripts", "eval-scannet"):
        path = os.path.join(REPO, folder, name + ".py")
        if os.path.isfile(path):
            return Background([sys.executable, path] + [str(a) for a in args],
                              log, env=env)
    raise FileNotFoundError(name)


def face_colors(path):
    from semantic_meshes_torch.io.ply import read_ply

    e = read_ply(str(path))
    return np.stack([e["face"].data["red"], e["face"].data["green"],
                     e["face"].data["blue"]], -1)


def near_ties(fused, eps=1e-5):
    """Faces whose two largest fused probabilities differ by less than
    eps (where an argmax may fairly differ between the frameworks)."""
    fused = np.asarray(fused)
    top = np.sort(fused[fused.sum(-1) > 0], axis=-1)[:, -2:]
    return int(((top[:, 1] - top[:, 0]) < eps).sum())
