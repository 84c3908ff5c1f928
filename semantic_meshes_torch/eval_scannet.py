"""Evaluate semantic-meshes on the ScanNet dataset, on PyTorch.

    python -m semantic_meshes_torch.eval_scannet --scannet DIR
        [--device cuda|cpu] [the flags of eval-scannet/eval_scannet.py]

Counterpart of the repository's `eval-scannet/eval_scannet.py` (the JAX
package's entry point, itself a port of the reference benchmark): the
same flags, pipeline and YAML result schema, plus `--device` (default
"cuda", raising without a card):
  per scene: parse .sens -> build the renderer (triangles | texels) ->
  size its budgets over every frame (prepare) -> per frame: render or
  load the cached ids, predict, 2D network metrics, fuse -> vertex (3D)
  metrics through the face -> vertex adjacency -> a re-render pass for
  the fused 2D metrics -> YAML {params, metrics{vertex, image_network,
  image_fused}}.

The flat script is split so a caller can run one scene in-process without
the CLI's file IO: `parse_args`, `find_scenes`, `make_predictor`,
`read_label_map` / `load_gt_labels`, `metric_group`, `Session` (the
metric groups, timers and the checkpoint manifest across scenes),
`evaluate_scene` (the per-scene core: decoded frames in, metrics and the
aggregator out) and `run` (the CLI). `imageio` (PNG labels, JPEG colour,
debug images) and `yaml` are imported by `run` and the readers only;
`evaluate_scene` needs neither. The XLA-specific flags `--compile_cache`
and `--no_face_buckets` are accepted and do nothing: the port compiles no
XLA, and face bucketing is not ported.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import checkpoint as sm_checkpoint
from . import data, fusion, probs_io, render
from . import metrics as sm_metrics
from .data import resolve_device
from .profiling import PhaseTimers
from .utils import class_palette

CLASSES = 40
DONT_CARE_THRESHOLD = 0.9
PREFETCH = 8  # decoded frames in flight ahead of the frame loop


def build_parser():
    parser = argparse.ArgumentParser(
        description="Evaluate semantic-meshes on the scannet dataset"
    )
    parser.add_argument("--scannet", type=str, required=True,
                        help="Path to scannet directory")
    parser.add_argument("--images_equal_weight", type=float, default=0.5,
                        help="Soft boolean flag: 1.0 weights images equally "
                        "and 0.0 weights pixels equally in the fusion step")
    parser.add_argument("--frames_step", type=int, default=1,
                        help="Only use every n-th frame from a scene's "
                        "frames")
    parser.add_argument("--aggregator", type=str, default="mul",
                        choices=["sum", "summax", "mul"])
    parser.add_argument("--debug", type=str, default=None,
                        help="Path where debugging images/plys are stored "
                        "for the first scene")
    parser.add_argument("--output", type=str, default=None,
                        help="File/directory where results will be stored")
    parser.add_argument("--mesh", type=str, default="scannet",
                        choices=["scannet", "colmap"])
    parser.add_argument("--simplify", type=str, default="1.0",
                        help="Factor by which the mesh has been simplified")
    parser.add_argument("--offset", type=int, default=0,
                        help="Skip the first number of scenes")
    parser.add_argument("--num", type=int, default=-1,
                        help="Number of scenes to use")
    parser.add_argument("--cache", type=str, default=None,
                        help="Cache directory for rendered primitive images")
    parser.add_argument("--mode", type=str, default="triangles",
                        choices=["triangles", "texels"])
    parser.add_argument("--texel_resolution", type=float, default=0.1)
    parser.add_argument("--model", type=str, default="tfcv",
                        choices=["tfcv", "jax-unet", "probs"],
                        help="Predictor backend: original tfcv ESANet, the "
                        "bundled RGBDUNet (the name is the JAX package's; "
                        "here models.segmentation.load_rgbd_predictor), or "
                        "precomputed probability maps")
    parser.add_argument("--probs_dir", type=str, default=None,
                        help="With --model probs: <scene>/<frame>.npy dense "
                        "maps or <scene>/<frame>.npz top-k maps")
    parser.add_argument("--probs_dtype", type=str, default="f32",
                        choices=["f32", "f16", "bf16", "u8"],
                        help="With --model probs: wire dtype for the "
                        "per-frame host->device upload of dense maps "
                        "(fusion and metrics stay float32 on the device; "
                        "top-k maps ship as stored)")
    parser.add_argument("--params", type=str, default=None,
                        help="With --model jax-unet: flax msgpack checkpoint "
                        "of trained RGBDUNet weights (random init otherwise)")
    parser.add_argument("--model_widths", type=str, default="64,128,256,512",
                        help="With --model jax-unet: encoder channel widths "
                        "(must match the checkpoint)")
    parser.add_argument("--model_input_hw", type=str, default="480,640",
                        help="With --model jax-unet: network input H,W "
                        "(images are resized in/out)")
    parser.add_argument("--max_frames", type=int, default=None)
    parser.add_argument("--timings", action="store_true",
                        help="Print per-phase timings at the end; each phase "
                        "then ends in a device synchronize, so the times "
                        "are the device's")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="Directory for mid-run checkpoints: per-scene "
                        "aggregator state + global metric state. Re-running "
                        "with the same directory resumes exactly where an "
                        "interrupted run stopped")
    parser.add_argument("--checkpoint_every", type=int, default=500,
                        help="Checkpoint cadence in fused frames (0 = only at "
                        "scene boundaries). One checkpoint dir holds one "
                        "parametrization; a mismatched manifest starts fresh")
    parser.add_argument("--crash_after", type=int, default=None,
                        help="(testing) abort the process with exit code 3 "
                        "after fusing N frames")
    parser.add_argument("--compile_cache", type=str, default=None,
                        help="Accepted for the JAX entry point's command "
                        "lines; does nothing (the port compiles no XLA)")
    parser.add_argument("--no_face_buckets", action="store_true",
                        help="Accepted for the JAX entry point's command "
                        "lines; does nothing (face bucketing is not ported: "
                        "it only shares XLA compilations there)")
    parser.add_argument("--clip_near", action="store_true",
                        help="Near-plane clip instead of culling triangles "
                        "that cross z=0 (recommended for indoor scenes)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Device of rendering, prediction, fusion and "
                        "metrics (cuda raises without a card; cpu runs the "
                        "kernels' plain versions)")
    return parser


def parse_args(argv=None):
    return build_parser().parse_args(argv)


# ------------------------------------------------------------------ scenes

def find_scenes(args):
    """[(scene dir, mesh file)] of <scannet>/scans/scene* whose mesh
    exists, after --offset and --num (which it sets when negative)."""
    scans_dir = os.path.join(args.scannet, "scans")
    scenes = sorted(os.path.join(scans_dir, f) for f in os.listdir(scans_dir)
                    if f.startswith("scene"))
    total_scenes = len(scenes)
    if args.mesh == "scannet":
        suffix = ("_vh_clean_2.labels.ply" if float(args.simplify) == 1.0
                  else f"_vh_clean_2.labels_simplified-{args.simplify}.ply")
        scenes = [(s, os.path.join(s, os.path.basename(s) + suffix))
                  for s in scenes]
    else:
        scenes = [(s, os.path.join(s, "colmap", "mesh.ply")) for s in scenes]
    scenes = [(s, m) for s, m in scenes if os.path.isfile(m)]
    mesh_scenes = len(scenes)
    scenes = scenes[args.offset:]
    if args.num < 0:
        args.num = len(scenes)
    scenes = scenes[:args.num]
    print(f"Found {total_scenes} total scenes in {args.scannet}, "
          f"{mesh_scenes} scenes with mesh type {args.mesh}, using "
          f"{len(scenes)} scenes for evaluation")
    return scenes


def result_params(args):
    """The YAML's `params` (the parametrization a rerun skips on)."""
    params = dict(images_equal_weight=args.images_equal_weight,
                  frames_step=args.frames_step, mode=args.mode,
                  aggregator=args.aggregator, mesh=args.mesh, num=args.num,
                  offset=args.offset, simplify=args.simplify)
    if args.mode == "texels":
        params["texel_resolution"] = args.texel_resolution
    return params


def scene_cameras(sens):
    """(resolution (color H, W), frame -> data.Camera) of a SensFile, after
    the reference's sanity checks: identity colour extrinsics, intrinsics
    with only focal lengths and the principal point."""
    resolution = (int(sens.color_height), int(sens.color_width))
    if not np.all(np.isclose(sens.extrinsic_color, np.eye(4))):
        raise ValueError(f"Invalid color extrinsics: {sens.extrinsic_color}")
    intrinsic = np.asarray(sens.intrinsic_color)
    focal_lengths = np.asarray([intrinsic[0, 0], intrinsic[1, 1]])
    principal_point = np.asarray([intrinsic[0, 2], intrinsic[1, 2]])
    chk = intrinsic.copy()
    chk[0, 0] = chk[1, 1] = 1
    chk[0, 2] = chk[1, 2] = 0
    if not np.all(np.isclose(chk, np.eye(4))):
        raise ValueError(f"Invalid color intrinsics: {sens.intrinsic_color}")

    def frame_camera(frame):
        world_to_camera = np.linalg.inv(frame.camera_to_world)
        return data.Camera(world_to_camera[:3, :3], world_to_camera[:3, 3],
                           np.asarray([resolution[1], resolution[0]]),
                           focal_lengths, principal_point)

    return resolution, frame_camera


# --------------------------------------------------------------- predictor

def make_predictor(args, device):
    """predict(color (H, W, 3) uint8, depth (h, w) uint16 mm, out_hw) ->
    probs (out_hw..., CLASSES) float32 on `device`, for --model tfcv or
    jax-unet; None for --model probs (the maps ride in the frames)."""
    if args.model == "tfcv":
        import tensorflow as tf
        import tfcv

        pretrained = tfcv.model.pretrained.tuinicr.\
            esanet_resnet_v1b_34_nbt1d_nyuv2
        model, preprocess = pretrained.create(), pretrained.preprocess

        def predict(color, depth, out_hw):
            depth_t = tf.cast(tf.expand_dims(depth, -1), "float32")
            depth_p = tf.image.resize(depth_t, (480, 640), method="nearest")
            color_p = tf.image.resize(color, (480, 640), method="bilinear")
            color_p, depth_p = preprocess(color_p, depth_p)
            pred = model(
                [np.expand_dims(color_p, 0),
                 np.expand_dims(np.expand_dims(depth_p, 0), -1)],
                training=False,
            )[0]
            pred = tf.image.resize(pred, out_hw, method="bilinear")
            return torch.from_numpy(np.asarray(pred, np.float32)).to(device)

        return predict
    if args.model == "jax-unet":
        from .models import segmentation

        predictor = segmentation.load_rgbd_predictor(
            classes=CLASSES, params_path=args.params,
            widths=tuple(int(w) for w in args.model_widths.split(",")),
            input_hw=tuple(int(v) for v in args.model_input_hw.split(",")),
            device=device)

        def predict(color, depth, out_hw):
            probs = predictor(color, depth)
            if tuple(probs.shape[:2]) != tuple(out_hw):
                probs = segmentation.resize(probs[None], out_hw)[0]
            return probs

        return predict
    return None


# ------------------------------------------------------------------ labels

def read_label_map(tsv_path):
    """scannetv2-labels.combined.tsv -> an array mapping raw ScanNet ids to
    nyu40 classes - 1 (-1 = don't care)."""
    with open(tsv_path) as f:
        lines = [ln.strip() for ln in f.read().split("\n") if ln.strip()]
    header = lines[0].split()
    columns = collections.defaultdict(list)
    for line in lines[1:]:
        values = line.split("\t")
        if len(values) > len(header):
            raise ValueError(f"{tsv_path}: a row longer than the header")
        for name, value in zip(header[:len(values)], values):
            columns[name].append(value.strip())
    mapping = {int(s): int(n)
               for s, n in zip(columns["id"], columns["nyu40id"])}
    table = np.asarray([mapping.get(i, 0)
                        for i in range(max(mapping) + 1)]) - 1
    if table.min() < -1 or table.max() >= CLASSES:
        raise ValueError(f"{tsv_path}: nyu40 ids outside 0..{CLASSES}")
    return table


def load_gt_labels(scene, index, label_map):
    """label-filt/<index>.png (raw ids, colour resolution) as int32 nyu40
    labels with -1 = ignore."""
    import imageio.v2 as imageio

    gt = imageio.imread(os.path.join(scene, "label-filt", f"{index}.png"))
    gt = np.clip(gt, 0, len(label_map) - 1)
    return label_map[gt.astype(np.int64)].astype(np.int32)


def read_vertex_gt(mesh_file):
    """(face -> vertices (T, 3) int64, raw vertex labels (V,) int64) of a
    ScanNet labels mesh."""
    from .io.ply import read_ply

    gt_mesh = read_ply(mesh_file)
    return (np.asarray(gt_mesh["face"].data["vertex_indices"], np.int64),
            np.asarray(gt_mesh["vertex"].data["label"], np.int64))


# ----------------------------------------------------------------- metrics

def metric_group(dontcare_prediction, device):
    return [sm_metrics.Accuracy(CLASSES, dontcare_prediction, device),
            sm_metrics.MeanIoU(CLASSES, dontcare_prediction, device),
            sm_metrics.ConfusionMatrix(CLASSES, dontcare_prediction, device)]


GROUPS = (("vertex", "error"), ("image_network", "forbidden"),
          ("image_fused", "error"))


class Session:
    """What lasts across scenes: the three metric groups (`groups`, by
    the YAML's names), the phase timers, the count of fused frames (for
    --crash_after) and, with a checkpoint directory, the manifest.

    The manifest (`manifest.npz`: the scenes done, the current scene and
    its frame cursor, the params, the three groups' confusion matrices) is
    written after the scene's aggregator snapshot (`agg-<scene>.npz`), and
    the frame loop skips fusion and metrics by their own cursors, so a
    crash between the two writes never double-counts either. A manifest
    of another parametrization starts the run fresh."""

    def __init__(self, params, device, checkpoint_dir=None):
        self.params = params
        self.device = resolve_device(device)
        self.groups = {name: metric_group(dc, self.device)
                       for name, dc in GROUPS}
        self.timers = PhaseTimers()
        self.fused_frames = 0
        self.checkpoint_dir = checkpoint_dir
        self.scenes_done = set()
        self.resume_scene, self.resume_frames = None, 0
        if checkpoint_dir:
            os.makedirs(checkpoint_dir, exist_ok=True)
            self._load_manifest()

    def agg_path(self, scene_name):
        return os.path.join(self.checkpoint_dir, f"agg-{scene_name}.npz")

    def _manifest_path(self):
        return os.path.join(self.checkpoint_dir, "manifest.npz")

    def save_manifest(self, current_scene, frames_done):
        meta = dict(scenes_done=sorted(self.scenes_done),
                    current_scene=current_scene,
                    frames_done=int(frames_done), params=self.params)
        cms = {f"{key}_cm": self.groups[name][0].full_matrix.cpu().numpy()
               for name, key in (("vertex", "vertex"),
                                 ("image_network", "network"),
                                 ("image_fused", "fused"))}
        path = self._manifest_path()
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez_compressed(
                f, meta=np.frombuffer(json.dumps(meta).encode(), np.uint8),
                **cms)
            f.flush()
            os.fsync(f.fileno())  # survive power loss, not only SIGKILL
        os.replace(tmp, path)

    def _load_manifest(self):
        path = self._manifest_path()
        if not os.path.isfile(path):
            return
        with np.load(path) as stored:
            meta = json.loads(bytes(stored["meta"].tobytes()).decode())
            if meta.get("params") != self.params:
                print("Checkpoint manifest is for a different "
                      "parametrization; starting fresh")
                return
            for name, key in (("vertex", "vertex_cm"),
                              ("image_network", "network_cm"),
                              ("image_fused", "fused_cm")):
                for m in self.groups[name]:
                    # float32, as the JAX package keeps it (counts past
                    # 2^24 round there too)
                    m._cm = torch.from_numpy(stored[key]).to(
                        device=self.device, dtype=m._cm.dtype)
        self.scenes_done = set(meta["scenes_done"])
        self.resume_scene = meta["current_scene"]
        self.resume_frames = meta["frames_done"]
        print(f"Resuming: {len(self.scenes_done)} scene(s) done"
              + (f", {self.resume_frames} frames into {self.resume_scene}"
                 if self.resume_scene else ""))

    def results(self):
        """{group: {metric name: float or nested list}} (the YAML's)."""
        out = {}
        for name, group in self.groups.items():
            out[name] = {}
            for m in group:
                value = m.result().cpu().numpy()
                out[name][m.name] = (value.tolist() if value.ndim > 1
                                     else float(value))
        return out


# --------------------------------------------------------------- the scene

def vertex_to_faces(face_to_vertices, n_vertices):
    """(V, max faces per vertex) int64: each vertex's faces in ascending
    order (a face once per corner it has there), padded with -1."""
    flat = face_to_vertices.reshape(-1)
    face_of = np.repeat(np.arange(len(face_to_vertices)),
                        face_to_vertices.shape[1])
    order = np.argsort(flat, kind="stable")
    verts, faces = flat[order], face_of[order]
    counts = np.bincount(verts, minlength=n_vertices)
    starts = np.cumsum(counts) - counts
    out = np.full((n_vertices, max(int(counts.max()), 1)), -1, np.int64)
    out[verts, np.arange(len(verts)) - starts[verts]] = faces
    return out


def _vertex_metrics(groups, annotations, vertex_gt, device):
    """Fused face distributions onto vertices (each vertex sums its faces'
    distributions, renormalised; under 0.9 total mass it is don't care)
    against the mesh's vertex labels (ref: eval_scannet.py:244-287)."""
    face_to_vertices, raw_labels = vertex_gt
    gt_vertex = sm_metrics.one_hot_with_ignore(
        raw_labels - 1, CLASSES, device).cpu().numpy()
    padded = np.concatenate(
        [annotations, np.zeros((1, CLASSES), np.float32)], 0)
    pred_vertex = padded[vertex_to_faces(face_to_vertices,
                                         len(raw_labels))].sum(1)
    dontcare = pred_vertex.sum(-1) < DONT_CARE_THRESHOLD
    with np.errstate(invalid="ignore", divide="ignore"):
        pred_vertex = pred_vertex / pred_vertex.sum(-1, keepdims=True)
    pred_vertex = np.where(dontcare[:, None], 0.0, np.nan_to_num(pred_vertex))
    for m in groups["vertex"]:
        m.update_state(gt_vertex, pred_vertex)
    gt_face = gt_vertex[face_to_vertices].sum(1)
    return gt_face.argmax(-1), gt_face.sum(-1) < DONT_CARE_THRESHOLD


def _read_cache(cache_dir, index):
    """Cached (H, W) uint32 ids of frame `index`, or None."""
    if cache_dir is None:
        return None
    path = os.path.join(cache_dir, f"frame-{index}.npz")
    if not os.path.isfile(path):
        return None
    with np.load(path) as stored:
        return stored["data"] if "data" in stored else None


def _host_ids(ids_wh):
    """(W, H) uint32 ids -> (H, W) numpy uint32."""
    return ids_wh.view(torch.int32).t().cpu().numpy().view(np.uint32)


def evaluate_scene(name, mesh, cameras, frames, predict, session, args, *,
                   labels, vertex_gt=None, imwrite=None, on_ids=None):
    """Fuse and score one scene into `session`'s metric groups.

    mesh: data.Ply. cameras: [(frame index, data.Camera)] of the frames
    the scene uses (--frames_step applied), in order. frames(start): an
    iterable of the decoded frames of cameras[start:], each (index,
    camera, color (H, W, 3) uint8, depth (h, w) uint16 mm, gt_labels
    (H, W) int32 with -1 ignore, probs: None, or with --model probs the
    loaded map (probs_io.load)). predict: make_predictor's function (None
    with --model probs). labels(index): the gt labels again, for the
    fused re-render pass. vertex_gt: read_vertex_gt's (face -> vertices,
    raw vertex labels), or None to skip the vertex metrics (texel mode, a
    COLMAP or simplified mesh). args: parse_args' namespace (mode,
    aggregator, images_equal_weight, texel_resolution, clip_near, cache,
    checkpoint_every, crash_after, debug, timings, device). imwrite(path,
    image): writes --debug images. on_ids(pass, index, ids (W, H)): sees
    every id image of the fuse pass ("fuse") and the re-render ("fused").

    Each step of a frame is a phase of session.timers (render, predict,
    metrics_network, fuse; then get, vertex, render_fused,
    metrics_fused), ending in a device synchronize with --timings.
    Checkpoints every --checkpoint_every frames when the session has a
    directory; exits with code 3 after --crash_after fused frames.
    Returns {"primitives", "frames", "fused", "overflow"}: the primitive
    count, the frames used, the fused (P, CLASSES) distributions on the
    device and the rasterizer's dropped candidates."""
    device = session.device
    timers = session.timers
    sync = args.timings and device.type == "cuda"

    @contextlib.contextmanager
    def phase(label):
        with timers.phase(label):
            yield
            if sync:
                torch.cuda.synchronize(device)

    print("Initializing semantic-meshes...")
    frame_cams = [cam for _, cam in cameras]
    if args.mode == "triangles":
        renderer = render.triangles(mesh, clip_near=args.clip_near,
                                    device=device)
    else:
        renderer = render.texels(mesh, frame_cams, args.texel_resolution,
                                 clip_near=args.clip_near, device=device)
    # size the dense candidate budgets over every frame at once, so no
    # frame breaches them mid-scene
    renderer.prepare(frame_cams)
    aggregator = fusion.MeshAggregator(
        renderer.getPrimitivesNum(), CLASSES, aggregator=args.aggregator,
        images_equal_weight=args.images_equal_weight, device=device)
    agg_done = 0
    metrics_done = (session.resume_frames if name == session.resume_scene
                    else 0)
    ckpt = session.checkpoint_dir
    if ckpt and os.path.isfile(session.agg_path(name)):
        restored, agg_done, _ = sm_checkpoint.load_aggregator(
            session.agg_path(name), device=device)
        if restored.primitives == aggregator.primitives:
            aggregator = restored
            print(f"Restored aggregator for {name} at {agg_done} frames")
        else:
            print(f"Aggregator checkpoint for {name} has "
                  f"{restored.primitives} primitives, expected "
                  f"{aggregator.primitives}; starting the scene fresh")
            agg_done = metrics_done = 0
    print(f"Loaded scene with {renderer.getPrimitivesNum()} mesh-primitives "
          f"and {len(cameras)} frames")

    cache_dir = None
    if args.cache is not None:
        mode = ("triangles" if args.mode == "triangles"
                else f"texels-{args.texel_resolution}")
        cache_dir = os.path.join(
            args.cache, name,
            f"primitive_indices-{mode}-simplify-{args.simplify}")
        os.makedirs(cache_dir, exist_ok=True)
    palette = class_palette(CLASSES)

    done_prefix = min(agg_done, metrics_done)
    t0 = time.perf_counter()
    for fi, (index, camera, color, depth, gt_labels, probs) in enumerate(
            frames(done_prefix), start=done_prefix):
        with phase("render"):
            cached = _read_cache(cache_dir, index)
            if cached is None:
                ids_wh = renderer.render(camera)[0]
                if cache_dir is not None and args.mesh == "scannet":
                    np.savez_compressed(
                        os.path.join(cache_dir, f"frame-{index}.npz"),
                        data=_host_ids(ids_wh))
            else:
                ids_wh = cached.T
        if on_ids is not None:
            on_ids("fuse", index, ids_wh)
        with phase("predict"):
            if probs is None:
                probs = predict(color, depth, (int(camera.resolution[1]),
                                               int(camera.resolution[0])))
            else:
                probs = probs_io.densify(probs, device)
        if fi >= metrics_done:
            with phase("metrics_network"):
                for m in session.groups["image_network"]:
                    m.update_state_labels(gt_labels, probs)
        if fi >= agg_done:
            with phase("fuse"):
                aggregator.add(ids_wh, probs.transpose(0, 1))
            session.fused_frames += 1

        if (ckpt and args.checkpoint_every > 0
                and (fi + 1) % args.checkpoint_every == 0):
            sm_checkpoint.save_aggregator(session.agg_path(name), aggregator,
                                          views_done=max(fi + 1, agg_done))
            session.save_manifest(name, max(fi + 1, metrics_done))
        if (args.crash_after is not None
                and session.fused_frames >= args.crash_after):
            print(f"(--crash_after) aborting after {session.fused_frames} "
                  "fused frames")
            sys.exit(3)
        if args.debug is not None and index % 100 == 0:
            gt_np = np.asarray(gt_labels.cpu() if torch.is_tensor(gt_labels)
                               else gt_labels)
            imwrite(os.path.join(args.debug, f"{index}_color.png"),
                    np.asarray(color.cpu() if torch.is_tensor(color)
                               else color))
            imwrite(os.path.join(args.debug, f"{index}_gt.png"),
                    sm_metrics.colorize_classes(np.maximum(gt_np, 0), palette,
                                                gt_np < 0))
            imwrite(os.path.join(args.debug, f"{index}_pred.png"),
                    sm_metrics.colorize_classes(probs.argmax(-1), palette))
    print(f"Fused {len(cameras) - done_prefix} frames of {name} in "
          f"{time.perf_counter() - t0:.1f} s")

    if ckpt:
        # the frame loop is complete: a crash in the passes below resumes
        # without redoing any frame
        sm_checkpoint.save_aggregator(session.agg_path(name), aggregator,
                                      views_done=len(cameras))
        session.save_manifest(name, len(cameras))

    print("Computing primitive annotations...")
    with phase("get"):
        fused = aggregator.get()
        annotations = fused.cpu().numpy()
    dontcare = annotations.sum(-1) < DONT_CARE_THRESHOLD

    if vertex_gt is not None:
        with phase("vertex"):
            gt_face, gt_face_dontcare = _vertex_metrics(
                session.groups, annotations, vertex_gt, device)
        if args.debug is not None:
            mesh.save(os.path.join(args.debug, "mesh_pred.ply"),
                      sm_metrics.colorize_classes(annotations.argmax(-1),
                                                  palette, dontcare))
            mesh.save(os.path.join(args.debug, "mesh_gt.ply"),
                      sm_metrics.colorize_classes(gt_face, palette,
                                                  gt_face_dontcare))

    model_renderer = aggregator.renderer()
    for index, camera in cameras:
        with phase("render_fused"):
            cached = _read_cache(cache_dir, index)
            if cached is None:
                ids_wh = renderer.render(camera)[0]
                ids_hw = ids_wh.t()
            else:
                ids_hw = cached
            pred = model_renderer.render(ids_hw, background=0.0)
        if on_ids is not None and cached is None:
            on_ids("fused", index, ids_wh)
        with phase("metrics_fused"):
            for m in session.groups["image_fused"]:
                m.update_state_labels(labels(index), pred)
        if args.debug is not None and index % 100 == 0:
            imwrite(os.path.join(args.debug, f"{index}_fused.png"),
                    sm_metrics.colorize_classes(pred.argmax(-1), palette,
                                                pred.sum(-1) < 0.5))

    if ckpt:
        # the scene's contributions are all in the metric groups now:
        # commit them and retire its aggregator snapshot
        session.scenes_done.add(name)
        session.save_manifest(None, 0)
        if os.path.isfile(session.agg_path(name)):
            os.remove(session.agg_path(name))

    # a budget breach after the first frame is invisible per frame: one
    # sum of the renderer's counters reports dropped geometry
    dropped = renderer.overflow_total()
    if dropped:
        print(f"WARNING: rasterizer dropped {dropped} candidate pairs "
              f"in scene {name} (raise the candidate budget)")
    return {"primitives": renderer.getPrimitivesNum(),
            "frames": len(cameras), "fused": fused, "overflow": dropped}


# --------------------------------------------------------------------- CLI

def _prefetched(fn, items, workers=4, depth=PREFETCH):
    """fn over items in order on a thread pool, at most `depth` ahead."""
    items = iter(items)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        pending = collections.deque(
            pool.submit(fn, item) for item, _ in zip(items, range(depth)))
        while pending:
            result = pending.popleft().result()
            for item in items:
                pending.append(pool.submit(fn, item))
                break
            yield result


def run(args):
    """The CLI: every scene of --scannet through evaluate_scene, the
    per-scene report, the YAML `run-<i>.yaml` in --output and the
    timings. Returns the exit code (0)."""
    import imageio.v2 as imageio
    import yaml

    device = resolve_device(args.device)
    scenes = find_scenes(args)
    params = result_params(args)
    # skip an already computed parametrization (ref: eval_scannet.py:70-78)
    if args.output is not None and os.path.isdir(args.output):
        for file in sorted(os.listdir(args.output)):
            if file.endswith(".yaml"):
                path = os.path.join(args.output, file)
                with open(path) as f:
                    earlier = yaml.safe_load(f)
                if earlier is not None and earlier.get("params") == params:
                    print(f"Parametrization already exists in {path}")
                    return 0
    if args.debug is not None:
        os.makedirs(args.debug, exist_ok=True)

    print("Loading predictor...")
    predict = make_predictor(args, device)
    print("Creating label maps from scannet to nyu40...")
    label_map = read_label_map(
        os.path.join(args.scannet, "scannetv2-labels.combined.tsv"))
    session = Session(params, device, args.checkpoint)

    from .data2 import SensFile

    for scene_index, (scene, mesh_file) in enumerate(scenes):
        name = os.path.basename(scene)
        if name in session.scenes_done:
            print(f"Scene {name} already fused (checkpoint); skipping")
            continue
        sens = SensFile(os.path.join(scene, name + ".sens"),
                        max_frames=args.max_frames)
        _, frame_camera = scene_cameras(sens)
        used = list(enumerate(sens.frames))[::args.frames_step]
        cameras = [(index, frame_camera(frame)) for index, frame in used]
        frame_of = dict(used)

        def load_frame(item, scene=scene, name=name, sens=sens,
                       frame_of=frame_of):
            """IO worker: decode colour, depth and labels; start the
            upload of a probability map."""
            index, camera = item
            frame = frame_of[index]
            color = frame.decompress_color(sens.color_compression_type)
            depth = np.frombuffer(
                frame.decompress_depth(sens.depth_compression_type),
                dtype="<u2").reshape(sens.depth_height, sens.depth_width)
            probs = None
            if args.model == "probs":
                probs = probs_io.load(
                    os.path.join(args.probs_dir, name, str(index)),
                    wire=args.probs_dtype, device=device)
            return (index, camera, color, depth,
                    load_gt_labels(scene, index, label_map), probs)

        vertex_gt = None
        if (args.mode == "triangles" and args.mesh == "scannet"
                and float(args.simplify) == 1.0):
            vertex_gt = read_vertex_gt(mesh_file)
        evaluate_scene(
            name, data.Ply(mesh_file), cameras,
            lambda start, fn=load_frame, cams=cameras: _prefetched(
                fn, cams[start:]),
            predict, session, args,
            labels=lambda index, scene=scene: load_gt_labels(
                scene, index, label_map),
            vertex_gt=vertex_gt, imwrite=imageio.imwrite)

        # per-scene report (ref: eval_scannet.py:322-326)
        row, headers = [scene_index + 1], ["Scenes"]
        for prefix, (_, group) in zip(
                ("Vertex", "ImageNetwork", "ImageFused"),
                session.groups.items()):
            for m in group:
                v = m.result().cpu().numpy()
                row.append(float(v) if v.ndim == 0 else "<cm>")
                headers.append(f"{prefix}-{m.name}")
        print(" | ".join(headers))
        print(" | ".join(str(r)[:12] for r in row))
        if args.debug is not None:
            print("Stopping after first scene due to debug mode")
            break

    result = {"metrics": session.results(), "params": params}
    if args.output:
        os.makedirs(args.output, exist_ok=True)
        i = 1
        while os.path.isfile(os.path.join(args.output, f"run-{i}.yaml")):
            i += 1
        file = os.path.join(args.output, f"run-{i}.yaml")
        print(f"Saving results to {file}")
        with open(file, "w") as f:
            yaml.dump(result, f, default_flow_style=False)
    if args.timings:
        print(session.timers.report())
    print("Results:")
    print({"metrics": {k: {m: ("<matrix>" if isinstance(v2, list) else v2)
                           for m, v2 in v.items()}
                       for k, v in result["metrics"].items()},
           "params": result["params"]})
    return 0


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
