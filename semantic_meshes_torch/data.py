"""Public data layer: Camera, Ply, Colmap — reference-compatible classes.

Counterpart of `semantic_meshes/data.py`. Cameras and meshes hold numpy
arrays on the host; arrays move to the device only at the renderer
boundary (render.TrianglesRenderer). Unlike the JAX package, `Camera` is a
plain frozen dataclass (no pytree registration).

API parity targets:
- `data.Camera(rotation, translation, resolution, focal_lengths,
  principal_point)` (ref: python/semantic_meshes/include/Camera.h:16-57)
- `data.Ply(path)` + `.save(path, colors[, bin])`
  (ref: python/semantic_meshes/include/Ply.h:10-54)
- `data.Colmap(workspace)` + `.getCamera(index | path)`
  (ref: python/semantic_meshes/include/Colmap.h:8-26, src/data/Colmap.cpp:7-62)

`resolution` is (width, height).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch

from .io import colmap as colmap_io
from .io import ply as ply_io


def resolve_device(device):
    """torch.device for `device`; a CUDA device on a machine without one
    raises here rather than falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "semantic_meshes_torch: CUDA device requested but "
            "torch.cuda.is_available() is False; pass device='cpu' for the "
            "plain PyTorch path"
        )
    return device


@dataclass(frozen=True)
class Camera:
    """Pinhole camera: world->camera rigid transform + intrinsics.

    rotation (3,3) f32 and translation (3,) f32 map world points into camera
    space (p_cam = R p + t); focal_lengths/principal_point are in pixels;
    resolution is (width, height).
    """

    rotation: np.ndarray
    translation: np.ndarray
    focal_lengths: np.ndarray
    principal_point: np.ndarray
    resolution: tuple = field(default=(0, 0))
    # (4,) (k1, k2, p1, p2) classic wire (zeros = pinhole), or the (9,)
    # extended wire (8 param slots + model selector, geometry.LENS_*)
    distortion: np.ndarray = None

    def __init__(self, rotation, translation, resolution=None, focal_lengths=None,
                 principal_point=None, distortion=None):
        # Positional order matches the reference binding:
        # Camera(rotation, translation, resolution, focal_lengths, principal_point)
        object.__setattr__(self, "rotation", np.asarray(rotation, np.float32))
        object.__setattr__(self, "translation", np.asarray(translation, np.float32))
        object.__setattr__(
            self, "focal_lengths", np.asarray(focal_lengths, np.float32)
        )
        object.__setattr__(
            self, "principal_point", np.asarray(principal_point, np.float32)
        )
        res = np.asarray(resolution).reshape(2).astype(np.int64)
        object.__setattr__(self, "resolution", (int(res[0]), int(res[1])))
        if distortion is None:
            dist = np.zeros(4, np.float32)
        else:
            dist = np.asarray(distortion, np.float32).reshape(-1)
            if dist.size > 9:
                raise ValueError(
                    "distortion must be at most 4 params (k1, k2, p1, p2) "
                    "or the 9-wide extended lens wire (see geometry.LENS_*),"
                    f" got {dist.size}"
                )
            width = 4 if dist.size <= 4 else 9
            dist = np.pad(dist, (0, width - dist.size))
        object.__setattr__(self, "distortion", dist)
        if self.rotation.shape != (3, 3):
            raise ValueError(f"rotation must be (3, 3), got {self.rotation.shape}")
        if self.translation.shape != (3,):
            raise ValueError(
                f"translation must be (3,), got {self.translation.shape}"
            )

    @property
    def width(self):
        return self.resolution[0]

    @property
    def height(self):
        return self.resolution[1]


def stack_cameras(cameras):
    """Stack a list of same-resolution Cameras into batched numpy arrays
    (R (N,3,3), t (N,3), f (N,2), c (N,2))."""
    return (
        np.stack([c.rotation for c in cameras]),
        np.stack([c.translation for c in cameras]),
        np.stack([c.focal_lengths for c in cameras]),
        np.stack([c.principal_point for c in cameras]),
    )


def stack_distortions(cameras):
    """(N, 4) stacked (k1, k2, p1, p2) per camera (zeros for pinhole) —
    or (N, 9) on the extended wire when any camera carries an extended
    lens (classic vectors zero-pad losslessly)."""
    dists = [
        np.zeros(4, np.float32) if c.distortion is None
        else np.asarray(c.distortion, np.float32).reshape(-1)
        for c in cameras
    ]
    width = max(d.size for d in dists)
    return np.stack([np.pad(d, (0, width - d.size)) for d in dists])


class Ply:
    """Triangle mesh loaded from a PLY file.

    ref: python Ply binding (python/semantic_meshes/include/Ply.h:10-54).
    """

    def __init__(self, path):
        self.path = str(path)
        self.vertices, self.faces = ply_io.read_mesh(self.path)

    def save(self, path, annotation_colors, bin=True):
        """Save the mesh with per-face RGB colors (uint8-castable (T, 3)).

        Accepts numpy arrays or torch tensors (on any device).
        """
        if hasattr(annotation_colors, "detach"):
            annotation_colors = annotation_colors.detach().cpu().numpy()
        colors = np.asarray(annotation_colors)
        if colors.shape != (self.faces.shape[0], 3):
            raise ValueError(
                f"annotation colors must be ({self.faces.shape[0]}, 3), "
                f"got {colors.shape}"
            )
        ply_io.write_mesh(
            path, self.vertices, self.faces, colors.astype(np.uint8), binary=bin
        )


class Colmap:
    """COLMAP workspace: per-image cameras sorted by image name.

    ref: src/data/Colmap.cpp:7-62. Image metadata is sorted by name
    (Colmap.cpp:19-21); getCamera accepts an integer index or an image
    path/filename. Unknown names raise KeyError.
    """

    def __init__(self, workspace_path):
        self.workspace_path = str(workspace_path)
        self._cameras = colmap_io.read_cameras(self.workspace_path)
        images = colmap_io.read_images(self.workspace_path)
        self._images = sorted(images.values(), key=lambda im: im.name)
        self._name_to_index = {im.name: i for i, im in enumerate(self._images)}

    def getImageNum(self):
        return len(self._images)

    def getImageName(self, index):
        """Image filename at the name-sorted index."""
        return self._images[int(index)].name

    def getImageIndex(self, path):
        # exact image name first: COLMAP names are workspace-relative
        # paths and may be nested ('cam0/000123.jpg' in multi-camera rigs)
        name = str(path).rstrip("/")
        if name in self._name_to_index:
            return self._name_to_index[name]
        filename = os.path.basename(name)
        if filename not in self._name_to_index:
            raise KeyError(
                f"Image with name {filename} not found in colmap workspace"
            )
        return self._name_to_index[filename]

    def getCamera(self, image_id):
        if not isinstance(image_id, (int, np.integer)):
            image_id = self.getImageIndex(image_id)
        meta = self._images[image_id]
        cam = self._cameras[meta.camera_id]
        return Camera(
            meta.rotation().astype(np.float32),
            meta.tvec.astype(np.float32),
            cam.resolution,
            cam.focal_lengths.astype(np.float32),
            cam.principal_point.astype(np.float32),
            distortion=cam.distortion.astype(np.float32),
        )

    def getCameras(self):
        return [self.getCamera(i) for i in range(len(self._images))]
