"""Port of eval-scannet/run_colmap_on_scannet.py: COLMAP known-pose
reconstruction of ScanNet scenes.

    python -m semantic_meshes_torch.scripts.run_colmap_on_scannet
        --scannet DIR [--colmap_bin colmap] [--frames_step 1] [--offset 0]
        [--num -1] [--gpu]

For each scene under DIR/scans without a `colmap/` workspace: export the
colour frames of its `.sens` stream (data2.SensFile, JPEGs through
io.image), write the known-pose `cameras.txt` / `images.txt` /
`points3D.txt` in the JAX driver's text layout, then run the external
`colmap` binary through feature_extractor -> exhaustive_matcher ->
point_triangulator -> image_undistorter -> patch_match_stereo ->
stereo_fusion -> delaunay_mesher (realigning images.txt to the
database's image ids) and remove the intermediates. A failing scene is
removed and skipped. `--gpu` is COLMAP's own SIFT flag. The driver works
on the host only, so it takes no `--device`.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sqlite3
import subprocess
import sys

import numpy as np


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Run colmap reconstruction with known camera poses on "
        "scannet scenes"
    )
    parser.add_argument("--scannet", type=str, required=True)
    parser.add_argument("--colmap_bin", type=str, default="colmap")
    parser.add_argument("--frames_step", type=int, default=1)
    parser.add_argument("--offset", type=int, default=0)
    parser.add_argument("--num", type=int, default=-1)
    parser.add_argument("--gpu", action="store_true")
    return parser.parse_args(argv)


def rotation_to_quaternion(rotation):
    """Rotation matrix -> (w, x, y, z), stable in every branch."""
    m = np.asarray(rotation, np.float64)
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array(
            [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
             (m[1, 0] - m[0, 1]) / s]
        )
    i = int(np.argmax(np.diagonal(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(1.0 + m[i, i] - m[j, j] - m[k, k], 0.0)) * 2
    q = np.empty(4)
    q[0] = (m[k, j] - m[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (m[j, i] + m[i, j]) / s
    q[1 + k] = (m[k, i] + m[i, k]) / s
    return q


def _run(cmd, cwd=None):
    print("+", " ".join(cmd))
    subprocess.run(cmd, cwd=cwd, check=True)


def write_known_poses(sens, sparse_dir, frames_step):
    """cameras.txt (one PINHOLE camera), images.txt (a pose per exported
    frame, named <i>.jpg) and an empty points3D.txt."""
    fx, fy = sens.intrinsic_color[0, 0], sens.intrinsic_color[1, 1]
    cx, cy = sens.intrinsic_color[0, 2], sens.intrinsic_color[1, 2]
    with open(os.path.join(sparse_dir, "cameras.txt"), "w") as f:
        f.write(f"1 PINHOLE {sens.color_width} {sens.color_height} "
                f"{fx} {fy} {cx} {cy}\n")
    with open(os.path.join(sparse_dir, "images.txt"), "w") as f:
        image_id = 1
        for i in range(0, len(sens.frames), frames_step):
            world_to_cam = np.linalg.inv(sens.frames[i].camera_to_world)
            q = rotation_to_quaternion(world_to_cam[:3, :3])
            t = world_to_cam[:3, 3]
            f.write(f"{image_id} {q[0]} {q[1]} {q[2]} {q[3]} "
                    f"{t[0]} {t[1]} {t[2]} 1 {i}.jpg\n\n")
            image_id += 1
    open(os.path.join(sparse_dir, "points3D.txt"), "w").close()


def realign_image_ids(db, images_txt):
    """Rewrite images.txt's ids to the database's ids of the same names."""
    con = sqlite3.connect(db)
    name_to_id = dict(con.execute("SELECT name, image_id FROM images")
                      .fetchall())
    con.close()
    with open(images_txt) as f:
        lines = f.read().split("\n")
    fixed = []
    for ln in lines:
        parts = ln.split()
        if len(parts) == 10:
            parts[0] = str(name_to_id[parts[9]])
            fixed.append(" ".join(parts))
        else:
            fixed.append(ln)
    with open(images_txt, "w") as f:
        f.write("\n".join(fixed))


def reconstruct(args, scene, name, workspace):
    from ..data2 import SensFile

    sens = SensFile(os.path.join(scene, name + ".sens"))
    images_dir = os.path.join(workspace, "images")
    sparse_dir = os.path.join(workspace, "sparse")
    os.makedirs(images_dir, exist_ok=True)
    os.makedirs(sparse_dir, exist_ok=True)
    sens.export_color_images(images_dir, frame_skip=args.frames_step)
    write_known_poses(sens, sparse_dir, args.frames_step)

    db = os.path.join(workspace, "database.db")
    gpu = "1" if args.gpu else "0"
    colmap = args.colmap_bin
    _run([colmap, "feature_extractor", "--database_path", db,
          "--image_path", images_dir,
          "--ImageReader.camera_model", "PINHOLE",
          "--ImageReader.single_camera", "1",
          "--SiftExtraction.use_gpu", gpu])
    realign_image_ids(db, os.path.join(sparse_dir, "images.txt"))
    _run([colmap, "exhaustive_matcher", "--database_path", db,
          "--SiftMatching.use_gpu", gpu])
    triangulated = os.path.join(workspace, "triangulated")
    os.makedirs(triangulated, exist_ok=True)
    _run([colmap, "point_triangulator", "--database_path", db,
          "--image_path", images_dir, "--input_path", sparse_dir,
          "--output_path", triangulated])
    dense = os.path.join(workspace, "dense")
    _run([colmap, "image_undistorter", "--image_path", images_dir,
          "--input_path", triangulated, "--output_path", dense])
    _run([colmap, "patch_match_stereo", "--workspace_path", dense])
    _run([colmap, "stereo_fusion", "--workspace_path", dense,
          "--output_path", os.path.join(dense, "fused.ply")])
    _run([colmap, "delaunay_mesher", "--input_path", dense,
          "--output_path", os.path.join(workspace, "mesh.ply")])
    # keep the sparse model and the mesh
    for sub in ("images", "triangulated", "dense"):
        shutil.rmtree(os.path.join(workspace, sub), ignore_errors=True)
    if os.path.isfile(db):
        os.remove(db)


def main(argv=None):
    args = parse_args(argv)
    scans_dir = os.path.join(args.scannet, "scans")
    scenes = sorted(os.path.join(scans_dir, f) for f in os.listdir(scans_dir)
                    if f.startswith("scene"))
    scenes = scenes[args.offset:]
    if args.num >= 0:
        scenes = scenes[:args.num]
    for scene in scenes:
        name = os.path.basename(scene)
        workspace = os.path.join(scene, "colmap")
        if os.path.isdir(workspace):
            print(f"Skipping {name}: workspace exists")
            continue
        print(f"=== {name}")
        try:
            reconstruct(args, scene, name, workspace)
        except (subprocess.CalledProcessError, OSError, ValueError) as e:
            print(f"Scene {name} failed: {e}; skipping")
            shutil.rmtree(workspace, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
