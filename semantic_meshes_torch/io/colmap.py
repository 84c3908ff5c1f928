"""Numpy COLMAP sparse-model parser (cameras/images, .bin and .txt).

Own copy of the JAX package's `semantic_meshes/io/colmap.py`: the lazy
geometry imports point at this package's `geometry`, and `images.bin` is
read by the port's native one-pass indexer (`native.index_colmap_images`,
built at first use; a failed build raises), with the pure-python loop
kept as its plain version, `read_images_bin_plain`. Replaces
tt::colmap::readCameras / readImageMetaData (ref: src/data/Colmap.cpp:7-23).
Parses the documented public COLMAP format; raises proper exceptions
instead of the reference's print + exit(-1) (ref: src/data/Colmap.cpp:60-61).
"""

from __future__ import annotations

import glob
import os
import struct
from dataclasses import dataclass

import numpy as np

# COLMAP camera model id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),  # f, cx, cy
    1: ("PINHOLE", 4),  # fx, fy, cx, cy
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
_MODEL_NAME_TO_ID = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


class ColmapError(ValueError):
    pass


@dataclass
class ColmapCamera:
    camera_id: int
    model: str
    width: int
    height: int
    focal_lengths: np.ndarray  # (2,) f64 — (fx, fy); SIMPLE_PINHOLE duplicates f
    principal_point: np.ndarray  # (2,) f64
    # lens distortion on normalized coords: canonical (k1, k2, p1, p2) for
    # the classic models (zeros for pinhole), or the extended 9-wide wire
    # (8 param slots + model selector) for FULL_OPENCV / fisheye / FOV /
    # THIN_PRISM_FISHEYE (selectors and lens models in geometry.py)
    distortion: np.ndarray = None

    def __post_init__(self):
        if self.distortion is None:
            self.distortion = np.zeros(4)

    @property
    def resolution(self):
        """(width, height) — matches the reference Camera.resolution order
        (scripts pass [resolution[1], resolution[0]] = (W, H),
        ref: eval-scannet/eval_scannet.py:156)."""
        return np.array([self.width, self.height], dtype=np.int64)


@dataclass
class ColmapImage:
    image_id: int
    qvec: np.ndarray  # (4,) f64, (w, x, y, z), world->camera
    tvec: np.ndarray  # (3,) f64, world->camera
    camera_id: int
    name: str

    def rotation(self):
        from ..geometry import quaternion_to_rotation

        return np.asarray(quaternion_to_rotation(self.qvec), dtype=np.float64)


def _intrinsics_from_params(model_name, params):
    """Extract (focal_lengths, principal_point, distortion) from a COLMAP
    param vector. The reference rejects everything but the two pinhole
    models (its Camera union, ref: include/semantic_meshes/render/Camera.h:9-12)
    and tells users to undistort the workspace first; COLMAP's *default*
    output model is SIMPLE_RADIAL, so the whole radial/OpenCV/fisheye/FOV
    family is supported here natively. The classic models return the
    canonical (k1, k2, p1, p2) wire; FULL_OPENCV and the fisheye/FOV models
    return the extended 9-wide wire (8 param slots + model selector, see
    geometry.LENS_*). This covers COLMAP's entire camera-model zoo
    (camera_models.h), including THIN_PRISM_FISHEYE; the port's renderers
    accept only a zero lens so far.
    """
    from ..geometry import LENS_FISHEYE, LENS_FOV, LENS_THIN_PRISM

    zero = np.zeros(4)
    if model_name == "SIMPLE_PINHOLE":
        f, cx, cy = params[:3]
        return np.array([f, f]), np.array([cx, cy]), zero
    if model_name == "PINHOLE":
        fx, fy, cx, cy = params[:4]
        return np.array([fx, fy]), np.array([cx, cy]), zero
    if model_name == "SIMPLE_RADIAL":
        f, cx, cy, k = params[:4]
        return np.array([f, f]), np.array([cx, cy]), np.array([k, 0, 0, 0])
    if model_name == "RADIAL":
        f, cx, cy, k1, k2 = params[:5]
        return np.array([f, f]), np.array([cx, cy]), np.array([k1, k2, 0, 0])
    if model_name == "OPENCV":
        fx, fy, cx, cy, k1, k2, p1, p2 = params[:8]
        return (np.array([fx, fy]), np.array([cx, cy]),
                np.array([k1, k2, p1, p2]))
    if model_name == "FULL_OPENCV":
        fx, fy, cx, cy, k1, k2, p1, p2, k3, k4, k5, k6 = params[:12]
        return (np.array([fx, fy]), np.array([cx, cy]),
                np.array([k1, k2, p1, p2, k3, k4, k5, k6, 0.0]))
    if model_name == "OPENCV_FISHEYE":
        fx, fy, cx, cy, k1, k2, k3, k4 = params[:8]
        return (np.array([fx, fy]), np.array([cx, cy]),
                np.array([k1, k2, k3, k4, 0, 0, 0, 0, LENS_FISHEYE]))
    if model_name == "SIMPLE_RADIAL_FISHEYE":
        f, cx, cy, k = params[:4]
        return (np.array([f, f]), np.array([cx, cy]),
                np.array([k, 0, 0, 0, 0, 0, 0, 0, LENS_FISHEYE]))
    if model_name == "RADIAL_FISHEYE":
        f, cx, cy, k1, k2 = params[:5]
        return (np.array([f, f]), np.array([cx, cy]),
                np.array([k1, k2, 0, 0, 0, 0, 0, 0, LENS_FISHEYE]))
    if model_name == "FOV":
        fx, fy, cx, cy, omega = params[:5]
        return (np.array([fx, fy]), np.array([cx, cy]),
                np.array([omega, 0, 0, 0, 0, 0, 0, 0, LENS_FOV]))
    if model_name == "THIN_PRISM_FISHEYE":
        fx, fy, cx, cy, k1, k2, p1, p2, k3, k4, sx1, sy1 = params[:12]
        return (np.array([fx, fy]), np.array([cx, cy]),
                np.array([k1, k2, p1, p2, k3, k4, sx1, sy1,
                          LENS_THIN_PRISM]))
    raise ColmapError(
        f"unsupported COLMAP camera model {model_name}; supported: "
        "SIMPLE_PINHOLE, PINHOLE, SIMPLE_RADIAL, RADIAL, OPENCV, "
        "FULL_OPENCV, OPENCV_FISHEYE, SIMPLE_RADIAL_FISHEYE, "
        "RADIAL_FISHEYE, FOV, THIN_PRISM_FISHEYE"
    )


def _bin_read(f, n, path, what):
    """Read exactly n bytes or raise ColmapError (truncated .bin files would
    otherwise leak a raw struct.error)."""
    data = f.read(n)
    if len(data) != n:
        raise ColmapError(f"{path}: truncated COLMAP binary reading {what}")
    return data


def read_cameras_bin(path):
    cameras = {}
    with open(path, "rb") as f:
        (num,) = struct.unpack("<Q", _bin_read(f, 8, path, "camera count"))
        for _ in range(num):
            cam_id, model_id = struct.unpack(
                "<ii", _bin_read(f, 8, path, "camera header")
            )
            width, height = struct.unpack(
                "<QQ", _bin_read(f, 16, path, "camera resolution")
            )
            if model_id not in CAMERA_MODELS:
                raise ColmapError(f"{path}: unknown camera model id {model_id}")
            name, nparams = CAMERA_MODELS[model_id]
            params = np.frombuffer(
                _bin_read(f, 8 * nparams, path, "camera params"), dtype="<f8"
            )
            fl, pp, dist = _intrinsics_from_params(name, params)
            cameras[cam_id] = ColmapCamera(
                cam_id, name, width, height, fl, pp, dist
            )
    return cameras


def read_cameras_txt(path):
    cameras = {}
    with open(path, "r", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            # short or non-numeric lines raised IndexError/unpack ValueError
            # with no context (mutation fuzz) — give them a named error
            try:
                cam_id = int(parts[0])
                model_name = parts[1]
                if model_name not in _MODEL_NAME_TO_ID:
                    raise ColmapError(
                        f"{path}: unknown camera model {model_name}"
                    )
                width, height = int(parts[2]), int(parts[3])
                params = np.asarray([float(p) for p in parts[4:]])
                fl, pp, dist = _intrinsics_from_params(model_name, params)
            except ColmapError:
                raise
            except (IndexError, ValueError):
                raise ColmapError(
                    f"{path}: malformed cameras.txt line: {line!r}"
                ) from None
            cameras[cam_id] = ColmapCamera(
                cam_id, model_name, width, height, fl, pp, dist
            )
    return cameras


def read_images_bin(path):
    """images.bin through the native one-pass indexer (variable-length
    names defeat numpy vectorization); equals read_images_bin_plain."""
    from .. import native

    with open(path, "rb") as f:
        data = f.read()
    try:
        recs = native.index_colmap_images(data)
    except ValueError as e:  # typed-error contract: ColmapError
        raise ColmapError(f"{path}: {e}") from None
    return {
        int(r["image_id"]): ColmapImage(
            int(r["image_id"]),
            np.asarray(r["qvec"], np.float64),
            np.asarray(r["tvec"], np.float64),
            int(r["camera_id"]),
            data[
                int(r["name_offset"]):
                int(r["name_offset"]) + int(r["name_length"])
            ].decode("utf-8", errors="replace"),
        )
        for r in recs
    }


def read_images_bin_plain(path):
    """images.bin through the pure-python loop (the plain version of
    read_images_bin)."""
    images = {}
    with open(path, "rb") as f:
        (num,) = struct.unpack("<Q", _bin_read(f, 8, path, "image count"))
        for _ in range(num):
            (image_id,) = struct.unpack(
                "<i", _bin_read(f, 4, path, "image id")
            )
            qvec = np.frombuffer(
                _bin_read(f, 32, path, "qvec"), dtype="<f8"
            ).copy()
            tvec = np.frombuffer(
                _bin_read(f, 24, path, "tvec"), dtype="<f8"
            ).copy()
            (camera_id,) = struct.unpack(
                "<i", _bin_read(f, 4, path, "camera id")
            )
            name_bytes = bytearray()
            while True:
                c = f.read(1)
                if c == b"\x00" or c == b"":
                    break
                name_bytes += c
            (num_points,) = struct.unpack(
                "<Q", _bin_read(f, 8, path, "point count")
            )
            f.seek(num_points * 24, os.SEEK_CUR)  # skip 2D points (x, y, p3d_id)
            images[image_id] = ColmapImage(
                image_id, qvec, tvec, camera_id,
                name_bytes.decode("utf-8", errors="replace"),
            )
    return images


def read_images_txt(path):
    images = {}
    with open(path, "r", errors="replace") as f:
        # images.txt alternates metadata lines and points2D lines; points
        # lines may be blank (zero 2D points), so keep blanks for parity.
        lines = [ln.strip() for ln in f if not ln.strip().startswith("#")]
    for meta in lines[0::2]:
        if not meta:
            continue
        parts = meta.split()
        try:
            image_id = int(parts[0])
            qvec = np.asarray([float(x) for x in parts[1:5]])
            tvec = np.asarray([float(x) for x in parts[5:8]])
            camera_id = int(parts[8])
            name = parts[9]
        except (IndexError, ValueError):
            raise ColmapError(
                f"{path}: malformed images.txt metadata line: {meta!r}"
            ) from None
        images[image_id] = ColmapImage(image_id, qvec, tvec, camera_id, name)
    return images


def _find(workspace, stem):
    """Resolve `stem.bin` or `stem.txt` under the workspace, mirroring the
    reference's `cameras.*` glob (ref: src/data/Colmap.cpp:8-10). Also checks
    the conventional sparse/0 subdirectory."""
    for root in (workspace, os.path.join(workspace, "sparse"),
                 os.path.join(workspace, "sparse", "0")):
        for ext in (".bin", ".txt"):
            p = os.path.join(root, stem + ext)
            if os.path.isfile(p):
                return p
        hits = sorted(glob.glob(os.path.join(root, stem + ".*")))
        if hits:
            return hits[0]
    raise ColmapError(f"no {stem}.bin or {stem}.txt found in {workspace}")


def read_cameras(workspace):
    path = _find(workspace, "cameras")
    return read_cameras_bin(path) if path.endswith(".bin") else read_cameras_txt(path)


def read_images(workspace):
    path = _find(workspace, "images")
    return read_images_bin(path) if path.endswith(".bin") else read_images_txt(path)


def write_cameras_txt(path, cameras):
    """Write cameras.txt (used by the COLMAP-on-ScanNet script,
    ref: eval-scannet/run_colmap_on_scannet.py:80-104)."""
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera:\n")
        f.write("#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for cam in cameras.values():
            d = np.zeros(9)
            dc = np.asarray(cam.distortion, dtype=float).reshape(-1)
            d[: dc.size] = dc
            k1, k2, p1, p2 = d[:4]
            if cam.model == "SIMPLE_PINHOLE":
                params = [cam.focal_lengths[0], *cam.principal_point]
            elif cam.model == "SIMPLE_RADIAL":
                params = [cam.focal_lengths[0], *cam.principal_point, k1]
            elif cam.model == "RADIAL":
                params = [cam.focal_lengths[0], *cam.principal_point, k1, k2]
            elif cam.model == "OPENCV":
                params = [*cam.focal_lengths, *cam.principal_point,
                          k1, k2, p1, p2]
            elif cam.model in ("FULL_OPENCV", "THIN_PRISM_FISHEYE"):
                params = [*cam.focal_lengths, *cam.principal_point, *d[:8]]
            elif cam.model == "OPENCV_FISHEYE":
                params = [*cam.focal_lengths, *cam.principal_point, *d[:4]]
            elif cam.model == "SIMPLE_RADIAL_FISHEYE":
                params = [cam.focal_lengths[0], *cam.principal_point, k1]
            elif cam.model == "RADIAL_FISHEYE":
                params = [cam.focal_lengths[0], *cam.principal_point, k1, k2]
            elif cam.model == "FOV":
                params = [*cam.focal_lengths, *cam.principal_point, d[0]]
            else:
                params = [*cam.focal_lengths, *cam.principal_point]
            f.write(
                f"{cam.camera_id} {cam.model} {cam.width} {cam.height} "
                + " ".join(repr(float(p)) for p in params)
                + "\n"
            )


def write_images_txt(path, images):
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image:\n")
        f.write("#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        f.write("#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for img in images.values():
            q = " ".join(repr(float(x)) for x in img.qvec)
            t = " ".join(repr(float(x)) for x in img.tvec)
            f.write(f"{img.image_id} {q} {t} {img.camera_id} {img.name}\n\n")
