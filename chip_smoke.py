#!/usr/bin/env python3
"""Chip smoke run of semantic_meshes_torch on one CUDA card (sm_90a).

    python3 chip_smoke.py [--against DIR ...] [--sharded-only]
                          [--models-only] [--scripts-only] [--bench-only]

Drives the port's main paths through their public entry points, at six
of bench.py's presets, their distorted variants and their indoor
variants (random probabilities from a seed, made on the card), in phases;
each phase prints a line and raises on failure:

1. the card's name and power limit (nvidia-smi);
2. build of both CUDA kernels from csrc/ (one nvcc per source, all
   started together, those of --against too) and their -Xptxas -v
   register / shared-memory reports;
3. every kernel against its plain PyTorch version on the card: raster_tile
   on every view of `default` and `large` and on the hand-binned scenes of
   testing.TILE_SCENES, raster_dense on every view of
   `scannet` (twice, bit-identical) and of `default` forced through the
   dense rasterizer (ids equal, depths bit-equal, overflow 0), at the
   budgets the main path probes, on the hand-binned scenes of
   testing.DENSE_SCENES, and on every view of `texels` (its reordered
   faces, its probed budget); on clipped piece rows (clip_near=True):
   both kernels (raster_dense forced) on tests/test_clipping.py's random
   straddling scene at 1296x968, raster_tile on every view of `large`
   indoor and raster_dense on every view of `scannet` indoor (twice,
   bit-identical). Wherever raster_dense is checked on a view (here and
   in phases 6-12), the view's dense preparation by the dense_prep
   kernels (dense.resolve_inputs) is first held against the plain chain
   of PyTorch ops (dense.resolve_inputs_plain) on the same inputs, bit
   for bit (table, sorted ids up to starts[B + 1], starts, overflow,
   micro keys; 3 launches, 2 without a pair budget), and the plain
   raster_dense runs on the plain chain's output;
4. the main paths, each with every launch counter set to 0 just before it
   and read just after (every such window, here and later, also checks
   that the dense_prep kernels prepared each dense view: 3 launches a
   view resolved by raster_dense, 2 one without a pair budget; the main
   paths at `scannet`, `dense`, the texel presets and `scannet` indoor
   count their views too):
   - `large` (cube s=16, 3072 triangles, 8 views of 2048x1536, 19
     classes; the tile rasterizer): render -> MeshAggregator (sum, summax,
     mul) -> get -> palette colours -> Ply.save -> reload; overflow 0;
     raster_tile launches == views rasterized; fuse_views_planned equals
     the per-view path; a repeated fusion is bit-identical;
   - `scannet` (cube s=91, 99372 triangles, 8 views of 1296x968, 40
     classes; the dense rasterizer by auto dispatch): the same chain, plus
     prepare and render_many; raster_dense launches == views rendered with
     a nonzero pair budget;
   - `dense` (cube s=204, 499392 triangles, 4 views of 1024x768, 19
     classes): plan_fuse splits (uni-slot prefix), and fuse_views_planned
     in original face order equals the unsplit plan's fusion;
   - texel mode: reorder_faces_for_texels and _texel_resolutions on the
     card equal the CPU's on every face at `texels` and `texels01`; at
     `texels` (cube s=64, 49152 triangles, 4 views of 1024x768, 19
     classes, 2.0 texels per pixel: 809984 texels) and `texels01` (cube
     s=91, 8 views of 1296x968, 40 classes, 0.1: 99372 texels, one per
     triangle) texels -> prepare -> render -> render_many ->
     MeshAggregator sum/summax/mul -> get -> colours, then
     fuse_views_texels under plan_fuse(allow_split=False) == the per-view
     path, twice bit-identical; overflow 0; raster_dense launches == views
     rasterized with pairs, none of raster_tile; every texel id < P; the
     card's texel shader == the CPU's on every view, from the card's
     triangle ids; at `texels01` each id == first_texel_index[face]; a
     texel renderer at `default` (2.0 texels per pixel) through
     raster_tile, one launch a view;
   - lens distortion (bench.py has no distorted preset; the lenses are
     RADIAL_SCANNET, FISHEYE and RADIAL_LARGE below, nothing cut):
     `scannet` + SIMPLE_RADIAL on all 8 views (kernel B): prepare ->
     render -> render_many -> MeshAggregator sum/summax/mul -> get -> PLY,
     plan_fuse(distortions=) with lens_shared + fuse_views_planned twice
     == per-view, bit-identical, == the same batch with
     shared_lens=False; `large` with mixed lenses (fisheye on views 0-3
     on the 9-wide wire, zero lenses on 4-5, SIMPLE_RADIAL on 6-7; kernel
     A): render_many == render on one view of each nonzero lens, the
     zero-lens views == their pinhole renders bit for bit,
     fuse_views(distortions=) == per-view; the `default` texel renderer
     under `large`'s lenses through raster_tile and forced through
     raster_dense (fuse_views_texels(backend="dense")):
     fuse_views_texels == per-view, every id < P; overflow 0 and each
     kernel once per view rasterized everywhere; the undistortion grid
     on the card against the CPU at full size (one view per lens: the
     classic wire bit for bit, the extended wire's differences, and its
     ids after the resample on at most 1e-4 of the pixels);
   - near-plane clipping (bench.py has no indoor preset; ROOM_SIZE and
     INDOOR_RING below move a preset's cameras inside its cube, nothing
     cut): `scannet` indoor (kernel B) and `large` indoor (kernel A) with
     clip_near=True: prepare -> render -> render_many -> MeshAggregator
     sum/summax/mul -> get -> PLY, plan_fuse(clip_near=True) with split_k
     0 and no remap, fuse_views_planned twice == per-view,
     bit-identical, fuse_views_split == fuse_views, overflow 0, every
     pixel covered, the kernel once per view rasterized with pairs;
     `texels01` indoor: the card's clipped texel sizing == the CPU's on
     every face, the same chain in texel mode, fuse_views_texels ==
     per-view, every id < P, the card's ray-form shader == the CPU's bit
     for bit on every view; `scannet` indoor + SIMPLE_RADIAL: render_many
     == render, clipped under the virtual focal;
5. times with CUDA events (medians after warm-up): each kernel's time
   per view both as `ms`, from replays of a CUDA graph of its launches
   (the device's own time), and as `launched_ms`, with Python launching
   the views one by one as the main path does; its plain version; the
   bound of its work from this run's inputs (the (candidate, warp) tests
   its cull left, as the kernel counts them, against the bytes); each
   kernel also on each view's heaviest tile alone and with the share of
   (candidate, warp) tests its cull skipped; raster_tile with every tile
   empty, raster_dense with its work items; the pieces of a dense view at
   `scannet`, the routing cost model's coefficients they give, one
   fuse_views_planned batch per preset as `rasterize_fuse_throughput`,
   and one traced batch per preset (idle share, top device kernels); at
   the texel presets the pieces of a view (setup + dense binning,
   raster_dense, the texel shader, fusion), one fuse_views_texels batch
   as `rasterize_fuse_throughput` and one traced batch; the lens pieces
   (the classic grid once per batch, the extended grid per view,
   _resample_wh launched and in graph replays with its byte bound) and
   one batch (timed in phase 4 where the lenses are extended) and one
   traced batch of each distorted variant, and
   `scannet` + SIMPLE_RADIAL against `scannet` in turns; one batch and
   one traced batch per indoor variant, the clipped `scannet` indoor
   batch against the culled one of the same cameras in turns, and the
   clipper and the clipped setup per view (launched and in graph
   replays) against the culled setup; the dense preparation at `scannet`
   per view (dense_prep kernels and sort, launched and in graph replays,
   the plain chain launched) against the bound of the bytes it moves;
   fusion of one view (fusion_kernel: the fusion kernels and the sort) at
   the benchmark's `scannet-eval`, `cityscapes-demo` and `scannet-room`
   shapes, on 8 rendered views each: == the plain chain
   (fusion._segment_sums_plain) on every view (rows inside one chunk of
   sorted positions bit for bit, the others within rtol 1e-5) and
   bit-identical twice, then per view its ms (graph replays and
   launched), each kernel's device ms without the sort, the launch calls,
   the plain chain's ms and launch calls, and the bound of its bytes.
   The kernel line's `launches` counts `large` and `scannet`;
   `launches_by_path` every path's run; its `dense_prep` row the
   preparation's, its `fusion` row the fusion kernels' (every window
   that reads the counters holds them to 3 launches for each view the
   window fused on the card).

6. the ScanNet eval path (eval_scannet.py around the renderer, the model
   left out) at `scannet`, every step a PhaseTimers phase: a
   1024-frame .sens stream written with data2.scannet.write_sens (the
   views' rendered depth in mm at 640x480, random colour blobs of a
   JPEG's size, the timestamps shuffled); read by the native reader (the
   host IO library, built by g++ in this phase) and the python one:
   headers, frame order, payloads and every decoded depth equal, index
   and decode times; cameras of frames[::128] within 1e-5 of the
   preset's; seeded face labels, the label images from the port's
   render, peaked network probabilities (two views partly flipped) on
   disk as f32 .npy and top-3 .npz; probs_io.load on the f32, f16, u8
   and top-k wires (read, pin, upload and densify times); fuse_views
   with probs=(values, indices) and predict_fn=TopKDensify(40) == the
   per-view render -> densify -> add path bit for bit, densify on the
   card == the CPU's on every view; checkpoint after 4 views and resume
   == straight; network (forbidden) and fused (error, ModelRenderer of
   get()) Accuracy / MeanIoU / ConfusionMatrix with the card's matrices
   == the CPU's; one pass of the frame loop traced by
   profiling.trace_to, with a user annotation per phase. The launch
   counters are read around it (`launches_by_path` "scannet eval").

7. multi-GPU fusion (distributed.make_sharded_fuse), on one card: each
   kernel on row bands at y_offset = row0 (`large` in 2 and 4 bands of
   768 and 384 rows and `default`'s mesh at 1296x968, raster_tile;
   `scannet`, raster_dense, 484 and 242 rows: no tile multiple), every
   band == the full render's rows and == plain (raster_dense on views 0
   and 1), overflow 0; `scannet` in 2 and 4 face blocks merged by (z
   bits, global id) == the full render; make_sharded_fuse at `scannet`
   in an NCCL world of one == fuse_views bit for bit, timed in turns
   with it. With two or more cards, one NCCL rank per card (spawned
   processes): `scannet` on views, plain and with shard_primitives;
   `large` on views x pixels; `scannet` on faces and on views x faces;
   `texels01` (texel_params) on views x faces; `scannet` indoor +
   clip_near and `scannet` + SIMPLE_RADIAL (shared_lens) on views, and
   first on each rank's card its row band of `scannet`'s view 0 prepared
   by the dense_prep kernels == the plain chain; each
   == fuse_views on one card within rtol 2e-5, atol 1e-5 with equal
   overflow, two runs bit-identical, timed in turns with the one-card
   batch (rasterize_fuse_throughput), rank 0's idle share from one
   traced batch, and each collective of a batch timed alone against its
   bound from its bytes and the NVLink bandwidth nvidia-smi reports. On
   one card a phase line says the multi-card part did not run and why.
   `launches_by_path` gains each sharded path (launches summed over the
   ranks). --sharded-only runs phases 1, 2 and 7 alone (for calls on
   several cards) and prints no kernel line.

8. the bundled segmentation predictors (models.segmentation) at full
   width, nothing cut: the resizes card == CPU (the antialiased bilinear
   shrinks 968x1296 -> 480x640 and 1024x2048 -> 512x512, the upsamples
   back, nearest 2x bit for bit); a ConvBlock(256, 512), the float32
   head (no TF32) and UNet(64..512) at 256x256 card == CPU within the
   CPU tests' bounds; bench.py's `e2e` preset (UNet(64..512), 19
   classes, 4 ring views of 2048x1024 uint8 from SEED, cube s=64, texels
   at 0.1 per pixel, fuse_views_texels(predict_fn=softmax(model(img /
   255))), sum): overflow 0, raster_dense once a view and raster_tile
   never, == the fusion of the stacked predictions, two runs
   bit-identical, e2e_image_time as bench.py computes it (min of 5
   batches / views, and the median), the predictor alone, its
   convolutions' FLOPs and share of the bf16 peak, one traced batch and
   the peak device memory; the ScanNet eval's RGBD predictor (40
   classes, input 480x640) at `scannet` on seeded colour and the port's
   own render in mm at 640x480, fuse_views(probs=(colors, depths),
   predict_fn=) == the per-view predict -> render -> add path, overflow
   0; the Cityscapes demo's PSPNet (input 512x512, sliding (512, 512),
   scales 0.75, 1.0, 1.25) on one 2048x1024 image, and card == CPU on a
   256x512 crop. `launches_by_path` gains "e2e" and "scannet RGBD eval".

9. segmentation training (models.training) and the ScanNet eval entry
   point (eval_scannet.evaluate_scene), nothing cut: the trainer at the
   eval's full width (RGBDUNet(64..512), 40 classes, input 480x640,
   batches of 8 frames of the `scannet` cube coloured by cube side under
   per-frame illumination and noise, lr 3e-3) until the loss is under 0.7
   of the first, its step time, frames per second, fwd+bwd convolution
   FLOPs against the bf16 peak and peak memory; the float32 head's weight
   gradient card vs CPU from the same captured tensors (no TF32), one
   step card vs CPU at full width on 2 frames of 96x128 (loss, every
   parameter's update within 2 lr), make_data_parallel_step in an NCCL
   world of one against single-card steps within their run-to-run noise,
   and save -> load_rgbd_predictor(params_path=) bit for bit; then
   evaluate_scene with the trained predictor (--model jax-unet, mul,
   triangles) on 8 views x 3 frames of 1296x968 at `scannet` with frames
   held in memory (no JPEG or PNG codec needed): raster_dense twice a
   frame (the fuse pass and the fused re-render), their ids equal,
   overflow 0, the matrices summing to the valid pixels, fused mean IoU
   above the network's, the phase timers in ms a frame; and the
   trained-fusion test's scene (108 triangles, 6 views of 128x96,
   RGBDUNet(8, 16, 32)) through the same core, raster_tile twice a frame,
   fused >= network. `launches_by_path` gains "scannet eval entry
   (trained RGBD)" and "trained fusion scene". --models-only runs phases
   1, 2, 8 and 9 alone and prints no kernel line.

10. the user scripts (semantic_meshes_torch.scripts) on the card, through
   main(argv) in process where launches are counted (every counter set
   to 0 just before a run and read just after) and as processes where
   the scripts run their own children, nothing cut: the Cityscapes demo
   at bench_cityscapes' defaults (20 views of 2048x1024, 19 classes, cube
   s=64: raster_dense; f16 maps made on the card from seeds, saved from
   pinned memory) through colorize_cityscapes_mesh --probs chunked and
   per view (equal colours, overflow 0, raster_dense once a view, and ==
   the fusion of resolve_dense_plain's ids on every view), then
   bench_cityscapes' probs and unet legs as processes; precompute_probs
   with the bundled UNet(64..512) on 4 views of 2048x1024 (float32 maps
   == load_predictor in process bit for bit; float16 and top-3 stores
   through the demo, the share of faces with equal colours >= 0.99);
   render_annotations on the demo scene in triangle mode and at 0.1
   texels a pixel (label PNGs == ModelRenderer's argmax over in-process
   renders, each primitive one label in every view); demo_cube at its
   defaults (raster_tile) and colorize_mesh --remap at `default`, card ==
   CPU byte for byte; resume_killtest at its defaults (the eval CLI on
   the card, SIGKILL at the first manifest, resume == straight exactly)
   and bench_eval at its defaults (43200 faces, 40 frames of 1296x968).
   `launches_by_path` gains the six in-process paths. --scripts-only runs
   phases 1, 2 and 10 alone and prints no kernel line.

11. the port's measuring surface: `python -m semantic_meshes_torch.bench`
   as a child process (the default preset with every sub-preset, then
   `--preset large` and `--preset e2e`), its JSON lines printed and
   gated: the headline first and every line of one value, no sub-preset
   skipped, every overflow 0, the launches of a batch (raster_tile once a
   view at `default` and `large`, raster_dense once a view at `scannet`,
   `texels` and `texels01` and 4 at `e2e`, none at `dense`); the bench's
   seconds_per_batch beside phase 5's batch (large, scannet, dense,
   texels, texels01) and its e2e_image_time beside phase 8's, with their
   ratios (printed, not gated: one card's batches move between calls);
   graft_entry.entry() on the card == on the CPU (rtol 2e-5, atol 1e-5)
   and graft_entry.dryrun_multichip(1), an NCCL world of one (under
   --sharded-only with two or more cards, one rank a card); every
   microbench (semantic_meshes_torch.scripts.microbench_*, every probe of
   microbench_segment_sum) in process at its default sizes, its JSON
   lines printed. `launches_by_path` gains "bench <preset>", "graft
   entry" and each microbench;
12. face bucketing (render._face_bucket), each path with the counters set
   to 0 just before it and read just after: the cube at s=3 (108 faces,
   padded to 1024 rows) on `default`'s views through raster_tile == the
   unbucketed renders, and raster_tile == plain on the padded rows; the
   cube at s=35 (14700 faces, padded to 16384 = DENSE_THRESHOLD) on
   `scannet`'s 8 views of 1296x968 through raster_dense == the unbucketed
   renderer forced dense, raster_dense == plain on every view, overflow
   0, no id of a padding row, beside the unbucketed tile route's dropped
   pairs and valid pixels and the two dense renderers timed in turns;
   `scannet`'s own mesh (99372 faces, padded to 114688) bucketed ==
   unbucketed, timed in turns; texels at 0.1 a pixel on the s=35 cube,
   bucketed == unbucketed forced dense; the eval CLI at its defaults
   (bucketed) on a fake ScanNet scene of that cube (4 frames of
   640x480): raster_dense launches, no raster_tile, the fused colours
   card == CPU, beside --no_face_buckets (raster_tile, its overflow, the
   faces whose colour moves). `launches_by_path` gains each path.
   --bench-only runs phases 1, 2, 11 and 12 alone and prints no kernel
   line.

No earlier path was cut to make room for phases 7 to 12.

--against DIR (repeatable) names a checkout of an earlier commit, e.g.
    mkdir -p build/parent && git archive <rev> semantic_meshes_torch |
        tar -x -C build/parent
whose package is loaded beside this one; its kernels are built with this
one's and timed in turns with them (DIR, ..., this, this, ..., DIR) on
the same inputs, and the kernel line gains an "against" entry per DIR.

The line before the last is the kernel table as one JSON object; the last
line is {"ok": true, "device": {...}}. Without a CUDA card, or without the
repository beside it, the script exits non-zero and prints no result.
"""

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import torch

# (subdivisions, views, width, height, classes) as in bench.py's PRESETS
SCENES = {
    "default": (9, 8, 1024, 768, 19),
    "large": (16, 8, 2048, 1536, 19),
    "dense": (204, 4, 1024, 768, 19),
    "scannet": (91, 8, 1296, 968, 40),
    "texels": (64, 4, 1024, 768, 19),
    "texels01": (91, 8, 1296, 968, 40),
}
# texels_per_pixel of bench.py's texel presets (bench.py:67), and of the
# texel check at `default`
TPP = {"texels": 2.0, "texels01": 0.1, "default": 2.0}
# texel primitives the sizing gives at the texel presets' cameras
TEXEL_P = {"texels": 809984, "texels01": 99372}
IEW = 0.5
SEED = 0
# lens wires of the distorted variants (bench.py has no distorted preset):
# SIMPLE_RADIAL (COLMAP's default model) on all of `scannet`'s views, one
# physical camera; at f = 0.9 * 968 its corner radius is 0.93 and its fold
# 1.83, so the lens inverts over the whole frame. `large` mixes the
# 9-wide OPENCV_FISHEYE wire of tests/test_lens_models.py, zero lenses and
# SIMPLE_RADIAL k1 = 0.1 (LARGE_LENSES).
RADIAL_SCANNET = (-0.1, 0.0, 0.0, 0.0)
RADIAL_LARGE = (0.1, 0.0, 0.0, 0.0)
FISHEYE = (0.03, -0.011, 0.002, -0.0005, 0.0, 0.0, 0.0, 0.0, 1.0)
LARGE_LENSES = [FISHEYE] * 4 + [None] * 2 + [RADIAL_LARGE] * 2
# indoor variants (bench.py has none): a preset's mesh, views and classes
# with the cameras moved inside, rendered with clip_near=True, nothing cut:
# the cube at ROOM_SIZE (a 4 m room; `scannet`'s s=91 gives 4.4 cm
# triangles), the views on a ring of radius 0.8 m at eye height 1.5 m above
# the floor (0.625 x the radius below the room's centre), looking at
# (0, -0.9, 0), at the preset's focal (0.9 x height)
ROOM_SIZE = 4.0
INDOOR_RING = dict(radius=0.8, elevation=-0.625, target=(0.0, -0.9, 0.0))
# H100 SXM peaks (NVIDIA data sheet): non-tensor fp32 and HBM3 bandwidth.
# The 67 TFLOP/s counts an FMA as two operations; the kernels round every
# multiply and add on its own (-fmad=false), one per lane and clock, so
# their operations run at half that rate.
PEAK_FP32_FLOPS = 67e12
PEAK_FP32_OPS = PEAK_FP32_FLOPS / 2
PEAK_BYTES_S = 3.35e12
# fp32 operations per (candidate, pixel): four affine forms a*px + b*py +
# c, a multiply and two adds each once a*px is taken out of the pixel loop
# (a thread's pixels share a column)
FLOPS_PER_TEST = 12
HERE = os.path.dirname(os.path.abspath(__file__))


_START = time.monotonic()


def phase(msg):
    """Print one phase line, with the seconds since the script started."""
    print(f"{msg} [{time.monotonic() - _START:.1f} s]", flush=True)


def card_lines():
    """Each card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return [line.strip() for line in out]


def card_line():
    return card_lines()[0]


def scene(name):
    from semantic_meshes_torch import testing

    sub, views, width, height, classes = SCENES[name]
    vertices, faces = testing.make_cube(subdivisions=sub)
    cams = testing.make_ring_cameras(num_views=views, width=width,
                                     height=height)
    return vertices, faces, cams


def device_probs(views, height, width, classes, device):
    """(N, H, W, C) softmax probabilities, made on the card from SEED."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    logits = torch.randn((views, height, width, classes), generator=gen,
                         device=device)
    return torch.softmax(logits, dim=-1)


def face_vertices(vertices, faces, device):
    """(T, 3, 3) face-vertex positions on the card, as the renderer keeps
    them."""
    return torch.as_tensor(vertices[faces], dtype=torch.float32,
                           device=device)


def cam_kw(cam):
    return dict(height=cam.resolution[1], width=cam.resolution[0])


def cam_args(cam):
    return (cam.rotation, cam.translation, cam.focal_lengths,
            cam.principal_point)


def view_inputs(fv, cam, device, clip_near=False):
    """Setup + binning of one view for the tile kernel from device face
    vertices `fv`, as the renderer runs it: (resolve_tiles arguments,
    overflow). clip_near: of the 2T clipped piece rows."""
    from semantic_meshes_torch.rasterize import tile_kernel

    return tile_kernel.resolve_inputs(None, None, *cam_args(cam),
                                      face_vertices=fv, clip_near=clip_near,
                                      device=device, **cam_kw(cam))


def dense_budget(vertices, faces, cams, device, backend=None,
                 clip_near=False):
    """The dense budget (a DenseBudget) the renderer probes for this
    camera set."""
    import semantic_meshes_torch as smt
    from types import SimpleNamespace

    r = smt.render.TrianglesRenderer(
        SimpleNamespace(vertices=vertices, faces=faces), backend=backend,
        clip_near=clip_near, device=device)
    r.prepare(cams)
    return r.dense_cap_policy._cap[(cams[0].resolution[1],
                                    cams[0].resolution[0])]


def dense_view_inputs(fv, cam, cap, device, clip_near=False):
    """Everything of one dense view before the kernel, at budget `cap`:
    (resolve_dense arguments, micro key, overflow)."""
    from semantic_meshes_torch import rasterize as rast

    return rast.dense.resolve_inputs(None, None, *cam_args(cam),
                                     face_vertices=fv, clip_near=clip_near,
                                     device=device, **cam_kw(cam),
                                     **rast.dense.DenseBudget.of(cap).kwargs())


def dense_view_pair(where, k, fv, cam, cap, device, clip_near=False,
                    y_offset=0.0, height=None):
    """One view's dense preparation at budget `cap`, twice on the card from
    the same inputs: by the dense_prep kernels (dense.resolve_inputs, as
    every dense path runs it) and by the plain chain of PyTorch ops they
    replaced (dense.resolve_inputs_plain). Raises unless the two agree bit
    for bit (the candidate table, the sorted ids up to the global bucket's
    end starts[B + 1], the starts, the overflow, the micro key image and
    the other arguments of resolve_dense) and the kernels took 3 launches
    (2 without a pair budget). height: a row band's, at y_offset (default
    the camera's, at 0). Returns (the kernels' resolve_dense arguments,
    the plain chain's, overflow)."""
    from semantic_meshes_torch import rasterize as rast
    from semantic_meshes_torch.rasterize import dense, dense_prep

    kw = dict(face_vertices=fv, clip_near=clip_near, device=device,
              height=cam.resolution[1] if height is None else height,
              width=cam.resolution[0],
              **rast.dense.DenseBudget.of(cap).kwargs())
    launches = dense_prep.launches
    args, key, ov = dense.resolve_inputs(None, None, *cam_args(cam),
                                         y_offset, **kw)
    launches = dense_prep.launches - launches
    pargs, pkey, pov = dense.resolve_inputs_plain(None, None, *cam_args(cam),
                                                  y_offset, **kw)
    torch.cuda.synchronize()
    faults = []
    want = 2 if args is None else 3
    if launches != want:
        faults.append(f"{launches} dense_prep launches, expected {want}")
    if (args is None) != (pargs is None):
        faults.append("one side has no pair budget")
    if not torch.equal(key, pkey):
        faults.append(f"micro keys differ on {int((key != pkey).sum())} "
                      "pixels")
    if int(ov) != int(pov):
        faults.append(f"overflow {int(ov)}, plain {int(pov)}")
    if args is not None and pargs is not None:
        table, sids, starts = args[:3]
        ptable, psids, pstarts = pargs[:3]
        if not torch.equal(table.view(torch.int32), ptable.view(torch.int32)):
            faults.append("candidate tables differ")
        if not torch.equal(starts, pstarts):
            faults.append("tile starts differ")
        else:
            end = int(pstarts[-1])
            if sids.shape != psids.shape or not torch.equal(sids[:end],
                                                            psids[:end]):
                faults.append(f"sorted ids differ before {end}")
        if not torch.equal(args[4], key):
            faults.append("the arguments' micro key is not the returned one")
        if ([a for a in args[3:] if not torch.is_tensor(a)]
                != [a for a in pargs[3:] if not torch.is_tensor(a)]):
            faults.append("the scalar arguments differ")
    if faults:
        raise AssertionError(f"{where} view {k}: the dense_prep kernels != "
                             "the plain chain: " + "; ".join(faults))
    return args, pargs, ov


def load_against(path, index):
    """The kernel wrappers of the package semantic_meshes_torch in the
    checkout at `path`, imported beside this one as module
    `_against<index>` (its kernels build into its own build/)."""
    pkg = os.path.join(os.path.abspath(path), "semantic_meshes_torch")
    name = f"_against{index}"
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    if spec is None:
        raise FileNotFoundError(f"--against {path}: no {pkg}/__init__.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return SimpleNamespace(
        build=importlib.import_module(f"{name}._build"),
        tile=importlib.import_module(
            f"{name}.rasterize.tile_kernel").resolve_tiles_cuda,
        dense=importlib.import_module(
            f"{name}.rasterize.dense_kernel").resolve_dense_cuda)


def timed(fn):
    """(fn()'s result, its device time in ms from CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def cuda_time_ms(fn, reps, warmup=2):
    """Median over `reps` of fn()'s device time in ms (CUDA events)."""
    for _ in range(warmup):
        fn()
    return statistics.median(timed(fn)[1] for _ in range(reps))


_capture_stream = []


def graph_time_ms(fn, reps):
    """Median over `reps` of the device time in ms of fn()'s launches:
    captured once in a CUDA graph and replayed, so the host's per-launch
    work does not enter the time. The warm-up runs on the stream of the
    capture, so the graph finds raster_dense's scratch for that stream
    already made."""
    if not _capture_stream:
        _capture_stream.append(torch.cuda.Stream())
    stream = _capture_stream[0]
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        fn()
    ms = cuda_time_ms(graph.replay, reps)
    del graph
    return ms


def assert_same_image(name, k, zk, ik, zp, ip):
    """Kernel vs plain version: ids equal, depths bit-equal. Returns the
    largest |depth difference| over finite pixels (0 when bit-equal)."""
    if not torch.equal(ik, ip):
        bad = int((ik != ip).sum())
        raise AssertionError(f"{name} view {k}: {bad} ids differ")
    fin = torch.isfinite(zp)
    if not torch.equal(fin, torch.isfinite(zk)):
        raise AssertionError(f"{name} view {k}: empty masks differ")
    if not torch.equal(zk.view(torch.int32), zp.view(torch.int32)):
        err = float((zk[fin] - zp[fin]).abs().max())
        raise AssertionError(
            f"{name} view {k}: depths not bit-equal (max |err| {err})")
    return float((zk[fin] - zp[fin]).abs().max()) if fin.any() else 0.0


def tile_vs_plain(device):
    """Phase 3, raster_tile at `default` and `large`, and on the hand-binned
    scenes of testing.TILE_SCENES (a tile at the 256 cap, slivers along
    the warps' rectangles, exact ties inside one rectangle and across two,
    ragged edges, a row band, an empty view)."""
    from semantic_meshes_torch import testing
    from semantic_meshes_torch.rasterize import tile_kernel

    max_err = 0.0
    for name in ("default", "large"):
        vertices, faces, cams = scene(name)
        fv = face_vertices(vertices, faces, device)
        for k, cam in enumerate(cams):
            args, _ = view_inputs(fv, cam, device)
            zk, ik = tile_kernel.resolve_tiles_cuda(*args)
            zp, ip = tile_kernel.resolve_tiles_plain(*args)
            torch.cuda.synchronize()
            max_err = max(max_err, assert_same_image(name, k, zk, ik, zp,
                                                     ip))
        phase(f"phase 3: raster_tile == plain at {name}: {len(cams)} views, "
              "ids equal, depths bit-equal")
    for name in testing.TILE_SCENES:
        args = testing.tile_resolve_scene(name, device)
        zk, ik = tile_kernel.resolve_tiles_cuda(*args)
        zp, ip = tile_kernel.resolve_tiles_plain(*args)
        torch.cuda.synchronize()
        max_err = max(max_err, assert_same_image(name, 0, zk, ik, zp, ip))
    phase(f"phase 3: raster_tile == plain on the hand-binned scenes "
          f"{list(testing.TILE_SCENES)}: ids equal, depths bit-equal")
    return max_err


def dense_inputs(name, device, backend=None):
    """(budget, [(resolve_dense arguments from the dense_prep kernels, the
    same from the plain chain, overflow)] per view) of scene `name` at the
    budget the renderer probes; the two preparations bit-equal
    (dense_view_pair)."""
    vertices, faces, cams = scene(name)
    fv = face_vertices(vertices, faces, device)
    cap = dense_budget(vertices, faces, cams, device, backend)
    views = []
    for k, cam in enumerate(cams):
        args, pargs, overflow = dense_view_pair(name, k, fv, cam, cap,
                                                device)
        if args is None:
            raise AssertionError(f"{name}: zero pair budget {cap}")
        views.append((args, pargs, overflow))
    return cap, views


def dense_vs_plain(device):
    """Phase 3, the dense preparation's kernels against the plain chain and
    raster_dense on their output against its plain version on the plain
    chain's, at `scannet` (auto dispatch) and at `default` forced dense, at
    the budgets the renderer probes, and raster_dense on the hand-binned
    scenes of testing.DENSE_SCENES (work-item boundaries, ties
    across items and between a global and an own candidate, long global
    buckets, empty tiles, slivers and off-screen vertices). At `scannet`
    the kernel runs twice per view and the two runs must give the same
    bits."""
    from semantic_meshes_torch import testing
    from semantic_meshes_torch.rasterize import dense_kernel

    max_err = 0.0
    for name, backend in (("scannet", None), ("default", "dense")):
        cap, views = dense_inputs(name, device, backend)
        shapes = []
        for k, (args, pargs, overflow) in enumerate(views):
            zk, ik = dense_kernel.resolve_dense_cuda(*args)
            zp, ip = dense_kernel.resolve_dense_plain(*pargs)
            if name == "scannet":
                z2, i2 = dense_kernel.resolve_dense_cuda(*args)
                if not (torch.equal(i2, ik) and torch.equal(
                        z2.view(torch.int32), zk.view(torch.int32))):
                    raise AssertionError(f"scannet view {k}: two runs of "
                                         "raster_dense differ")
            torch.cuda.synchronize()
            if int(overflow) != 0:
                raise AssertionError(f"{name} view {k}: overflow "
                                     f"{int(overflow)}")
            max_err = max(max_err, assert_same_image(name, k, zk, ik, zp,
                                                     ip))
            starts = args[2].long()
            B = starts.numel() - 2
            shapes.append((int(starts[B + 1] - starts[B]),
                           int((starts[1:B + 1] - starts[:B]).max())))
        twice = ", two runs per view bit-identical" if name == "scannet" \
            else ""
        phase(f"phase 3: dense_prep == plain chain (table, sorted ids, "
              f"starts, overflow, micro keys bit-equal; 3 launches a view) "
              f"and raster_dense == plain at {name} (budget {cap}): "
              f"{len(views)} views, ids equal, depths bit-equal, overflow 0"
              f"{twice}; (global bucket, heaviest own range) per view "
              f"{shapes}")
    for name in testing.DENSE_SCENES:
        args = testing.dense_resolve_scene(name, device)
        zk, ik = dense_kernel.resolve_dense_cuda(*args)
        zp, ip = dense_kernel.resolve_dense_plain(*args)
        torch.cuda.synchronize()
        max_err = max(max_err, assert_same_image(name, 0, zk, ik, zp, ip))
    phase(f"phase 3: raster_dense == plain on the hand-binned scenes "
          f"{list(testing.DENSE_SCENES)}: ids equal, depths bit-equal")
    return max_err


# windows of read_launches where a dense view was prepared off the
# dense_prep kernels' route or with other than their launches, or a view
# fused or texel-shaded on the card off the fusion or texel kernels'
# route; main (and each sharded rank) raises at its end if any
PREP_FAULTS = []

# views given to fusion._accumulate_view on the card since reset_launches
# (count_fused's wrapper counts them)
FUSED = {"views": 0}

# views given to render._texel_prim_image on the card since
# reset_launches (count_shaded's wrapper counts them)
SHADED = {"views": 0}


def count_fused():
    """Wrap fusion._accumulate_view, once a process, so that every view it
    is given on the card counts in FUSED. MeshAggregator.add and
    distributed.view_accumulate (every fuse_views path, the sharded fuse)
    call it through the module, so the count is the views the window fused,
    kept apart from fusion_kernel's own counters."""
    from semantic_meshes_torch import fusion

    inner = fusion._accumulate_view
    if getattr(inner, "counts_fused", False):
        return

    def accumulate_view(prim, probs, *args, **kwargs):
        if probs.is_cuda:
            FUSED["views"] += 1
        return inner(prim, probs, *args, **kwargs)

    accumulate_view.counts_fused = True
    fusion._accumulate_view = accumulate_view


def count_shaded():
    """Wrap render._texel_prim_image, once a process, so that every triangle
    -id image it is given on the card counts in SHADED. TexelsRenderer.
    _shade, fuse_views_texels and the sharded fuse call it through the
    module, so the count is the views the window shaded."""
    from semantic_meshes_torch import render

    inner = render._texel_prim_image
    if getattr(inner, "counts_shaded", False):
        return

    def texel_prim_image(*args, **kwargs):
        tri = args[6] if len(args) > 6 else kwargs["tri_index"]
        if tri.is_cuda:
            SHADED["views"] += 1
        return inner(*args, **kwargs)

    texel_prim_image.counts_shaded = True
    render._texel_prim_image = texel_prim_image


def reset_launches():
    from semantic_meshes_torch import fusion_kernel, texel_kernel
    from semantic_meshes_torch.rasterize import (dense_kernel, dense_prep,
                                                 tile_kernel)

    count_fused()
    count_shaded()
    tile_kernel.launches = 0
    dense_kernel.launches = 0
    dense_prep.launches = 0
    dense_prep.views = 0
    fusion_kernel.launches = 0
    fusion_kernel.views = 0
    FUSED["views"] = 0
    texel_kernel.launches = 0
    texel_kernel.views = 0
    SHADED["views"] = 0


def read_launches():
    """The kernels' launches since reset_launches. Also checks that the
    dense_prep kernels prepared every dense view of the window: 3 launches
    a view whose pairs kernel B then resolved, 2 a view with no pair
    budget (no kernel B), so their launches are 2 a view prepared plus
    raster_dense's; that the fusion kernels fused every view the window
    fused on the card (FUSED), 3 launches a view; and that the texel
    kernels shaded every view the window shaded on the card (SHADED), 2
    launches a view. A window that breaks any goes to PREP_FAULTS."""
    from semantic_meshes_torch.rasterize import dense_kernel, tile_kernel

    prep = read_prep()
    if prep["launches"] != 2 * prep["views"] + dense_kernel.launches:
        PREP_FAULTS.append(
            f"{prep['launches']} dense_prep launches for {prep['views']} "
            f"views prepared and {dense_kernel.launches} of raster_dense")
    fused = read_fusion()
    if (fused["views"] != FUSED["views"]
            or fused["launches"] != 3 * fused["views"]):
        PREP_FAULTS.append(
            f"{fused['launches']} fusion kernel launches for "
            f"{fused['views']} views, of {FUSED['views']} views fused on "
            "the card")
    shaded = read_texels()
    if (shaded["views"] != SHADED["views"]
            or shaded["launches"] != 2 * shaded["views"]):
        PREP_FAULTS.append(
            f"{shaded['launches']} texel kernel launches for "
            f"{shaded['views']} views, of {SHADED['views']} views shaded on "
            "the card")
    return {"raster_tile": tile_kernel.launches,
            "raster_dense": dense_kernel.launches}


def read_prep():
    """{"launches", "views"} of the dense_prep kernels since
    reset_launches."""
    from semantic_meshes_torch.rasterize import dense_prep

    return {"launches": dense_prep.launches, "views": dense_prep.views}


def read_fusion():
    """{"launches", "views"} of the fusion kernels since reset_launches."""
    from semantic_meshes_torch import fusion_kernel

    return {"launches": fusion_kernel.launches, "views": fusion_kernel.views}


def read_texels():
    """{"launches", "views"} of the texel kernels since reset_launches."""
    from semantic_meshes_torch import texel_kernel

    return {"launches": texel_kernel.launches, "views": texel_kernel.views}


def check_texels(label, shaded, views):
    """Raises unless the texel kernels shaded `views` views, 2 launches a
    view."""
    want = {"launches": 2 * views, "views": views}
    if shaded != want:
        raise AssertionError(f"{label}: texel kernels {shaded}, expected "
                             f"{want}")


def check_fusion(label, fused, views):
    """Raises unless the fusion kernels fused `views` views, 3 launches a
    view."""
    want = {"launches": 3 * views, "views": views}
    if fused != want:
        raise AssertionError(f"{label}: fusion kernels {fused}, expected "
                             f"{want}")


def check_prep(label, prep, budgets):
    """Raises unless the dense_prep kernels prepared one view for each
    dense budget in `budgets` (None: the default pair budget), 3 launches
    a view with a pair budget and 2 one without."""
    def pairs(c):
        from semantic_meshes_torch.rasterize import dense

        p = dense.DenseBudget.of(c).pairs
        return 1 if p is None else p

    want = {"launches": sum(3 if pairs(c) > 0 else 2 for c in budgets),
            "views": len(budgets)}
    if prep != want:
        raise AssertionError(f"{label}: dense_prep {prep}, expected {want}")


def raise_prep_faults():
    if PREP_FAULTS:
        raise AssertionError("views prepared off the dense_prep kernels' "
                             "route, fused off the fusion kernels' or "
                             "shaded off the texel kernels': "
                             + " | ".join(PREP_FAULTS))


def fuse_and_save(name, mesh, rendered, probs, classes, workdir, device,
                  texels=None):
    """MeshAggregator sum/summax/mul over rendered (W, H) id images ->
    get -> palette colours -> Ply.save -> reload. Returns the sum state.
    texels: the number of texel primitives of a texel renderer's images;
    their colours are per texel, so no PLY is written."""
    import semantic_meshes_torch as smt

    T = len(mesh.faces) if texels is None else texels
    palette = smt.utils.class_palette(classes)
    fused = None
    for agg_name in ("sum", "summax", "mul"):
        agg = smt.fusion.MeshAggregator(T, classes, agg_name, IEW,
                                        device=device)
        for k, ids in enumerate(rendered):
            agg.add(ids, probs[k].transpose(0, 1))
        out = agg.get()
        if tuple(out.shape) != (T, classes) or not torch.isfinite(out).all():
            raise AssertionError(f"{name} {agg_name}: bad fused output")
        seen = agg.state.abs().sum(-1) > 0
        sums = out[seen].sum(-1)
        if not seen.any() or not torch.allclose(
                sums, torch.ones_like(sums), atol=1e-5):
            raise AssertionError(f"{name} {agg_name}: rows not normalised")
        if agg_name == "sum":
            fused = agg.state.clone()
        colors = palette[out.argmax(-1).cpu().numpy()]
        colors[~seen.cpu().numpy()] = 0
        if texels is not None:
            continue
        out_path = os.path.join(workdir, f"{name}_{agg_name}.ply")
        mesh.save(out_path, colors)
        back = smt.io.ply.read_ply(out_path)["face"].data
        got = np.stack([back["red"], back["green"], back["blue"]], -1)
        if not np.array_equal(got, colors) or not np.array_equal(
                smt.data.Ply(out_path).faces, mesh.faces):
            raise AssertionError(f"{name} {agg_name}: PLY round trip differs")
    return fused


def planned_twice(name, plan, vertices, cams, probs, classes, device, **kw):
    """Two fuse_views_planned batches (keywords `kw` passed on); both
    bit-identical, neither dropping anything."""
    import semantic_meshes_torch as smt

    width, height = cams[0].resolution
    rot, trans, fl, pp = smt.data.stack_cameras(cams)
    runs = []
    for _ in range(2):
        acc, ov = smt.distributed.fuse_views_planned(
            plan, vertices, rot, trans, fl, pp, probs, IEW,
            num_primitives=len(plan.faces), aggregator="sum", height=height,
            width=width, device=device, **kw)
        if int(ov):
            raise AssertionError(f"{name}: fuse_views_planned overflow "
                                 f"{int(ov)}, expected 0")
        runs.append(acc)
    if not torch.equal(runs[0], runs[1]):
        raise AssertionError(f"{name}: repeated fusion is not bit-identical")
    return runs[0]


def main_path(name, device, workdir):
    """Phase 4 at `large` (tile rasterizer) or `scannet` (dense
    rasterizer), through the public API, launch counters read around it.
    Returns what phase 5 reuses."""
    import semantic_meshes_torch as smt

    sub, n_views, width, height, classes = SCENES[name]
    vertices, faces = smt.testing.make_cube(subdivisions=sub)
    path = os.path.join(workdir, f"{name}.ply")
    smt.io.ply.write_mesh(path, vertices, faces)
    mesh = smt.data.Ply(path)
    cams = smt.testing.make_ring_cameras(num_views=n_views, width=width,
                                         height=height)
    probs = device_probs(n_views, height, width, classes, device)
    rot, trans, fl, pp = smt.data.stack_cameras(cams)
    dense = smt.rasterize.uses_dense(None, len(faces))

    reset_launches()
    rasterized = []  # the dense budget of every view rasterized
    renderer = smt.render.triangles(mesh, device=device)
    if dense:
        renderer.prepare(cams)
    rendered = [renderer.render(cam)[0] for cam in cams]
    cap = renderer.dense_cap_policy._cap.get((height, width))
    rasterized += [cap] * n_views
    for ids in rendered:
        if ids.dtype != torch.uint32 or tuple(ids.shape) != (width, height):
            raise AssertionError(f"render() gave {ids.dtype} {ids.shape}")
    if dense:
        many, _ = renderer.render_many(cams)
        rasterized += [cap] * n_views
        if not torch.equal(many, torch.stack(rendered)):
            raise AssertionError(f"{name}: render_many != render")
    overflow = renderer.overflow_total()
    if overflow != 0:
        raise AssertionError(f"overflow {overflow} at {name}")
    fused_sum = fuse_and_save(name, mesh, rendered, probs, classes, workdir,
                              device)
    plan = smt.distributed.plan_fuse(vertices, faces, rot, trans, fl, pp,
                                     height=height, width=width,
                                     device=device)
    acc = planned_twice(name, plan, vertices, cams, probs, classes, device)
    rasterized += [plan.dense_e_cap] * (2 * n_views)
    torch.cuda.synchronize()
    launches = read_launches()
    prep = read_prep()
    check_prep(name, prep, rasterized if dense else [])
    # sum, summax and mul by add, then two planned batches
    fused = read_fusion()
    check_fusion(name, fused, 5 * n_views)

    kernel = "raster_dense" if dense else "raster_tile"
    other = "raster_tile" if dense else "raster_dense"
    expect = sum(1 for c in rasterized
                 if not dense or (c is not None and c.pairs > 0))
    if launches[kernel] != expect or launches[other] != 0:
        raise AssertionError(f"{name}: launches {launches} for {expect} "
                             f"views rasterized with pairs")
    if not torch.allclose(acc, fused_sum, rtol=1e-6, atol=0.0):
        err = float((acc - fused_sum).abs().max())
        raise AssertionError(f"{name}: planned != per-view (max |err| {err})")
    extra = (f"dense budget {cap} (render), plan {plan.dense_e_cap}; "
             f"prepare + render + render_many, " if dense else "")
    phase(
        f"phase 4: main path at {name} ok: {n_views} views {width}x{height}, "
        f"{len(faces)} triangles, {classes} classes, {extra}sum/summax/mul "
        f"fused, PLY saved and reloaded, overflow 0, launches {launches} == "
        f"{expect} views rasterized with pairs, dense_prep {prep}, fusion "
        f"{fused}, planned == per-view "
        f"(bit-equal: {torch.equal(acc, fused_sum)}), repeated fusion "
        "bit-identical"
    )
    return dict(vertices=vertices, faces=faces, cams=cams, probs=probs,
                plan=plan, rot=rot, trans=trans, fl=fl, pp=pp, cap=cap,
                launches=launches[kernel], prep_launches=prep["launches"],
                fusion_launches=fused["launches"])


def dense_preset(device):
    """Phase 4 at `dense`: the split plan against the unsplit one."""
    import semantic_meshes_torch as smt

    sub, n_views, width, height, classes = SCENES["dense"]
    vertices, faces, cams = scene("dense")
    rot, trans, fl, pp = smt.data.stack_cameras(cams)
    probs = device_probs(n_views, height, width, classes, device)
    reset_launches()
    plans = {}
    accs = {}
    for split in (True, False):
        plans[split] = smt.distributed.plan_fuse(
            vertices, faces, rot, trans, fl, pp, height=height, width=width,
            allow_split=split, device=device)
        accs[split] = planned_twice("dense", plans[split], vertices, cams,
                                    probs, classes, device)
    torch.cuda.synchronize()
    launches = read_launches()
    prep = read_prep()
    check_prep("dense", prep, [plans[True].dense_e_cap] * (2 * n_views)
               + [plans[False].dense_e_cap] * (2 * n_views))
    fused = read_fusion()
    check_fusion("dense", fused, 4 * n_views)
    split_k = [plans[s].dense_e_cap.split_k for s in (True, False)]
    if split_k[0] <= 0 or split_k[1] != 0:
        raise AssertionError(f"dense: split_k {split_k[0]} / {split_k[1]}")
    if not torch.allclose(accs[True], accs[False], rtol=1e-6, atol=0.0):
        err = float((accs[True] - accs[False]).abs().max())
        raise AssertionError(f"dense: split != unsplit (max |err| {err})")
    if launches["raster_tile"] != 0:
        raise AssertionError(f"dense: launches {launches}")
    phase(
        f"phase 4: dense preset ok: {n_views} views {width}x{height}, "
        f"{len(faces)} triangles; split plan {plans[True].dense_e_cap} "
        f"(split_k {split_k[0]} of {len(faces)}), unsplit plan "
        f"{plans[False].dense_e_cap}; split == unsplit in original face "
        f"order (bit-equal: {torch.equal(accs[True], accs[False])}), "
        f"overflow 0, repeated fusion bit-identical, launches {launches} "
        f"(a zero pair budget runs no kernel), dense_prep {prep}, fusion "
        f"{fused}"
    )
    return dict(vertices=vertices, faces=faces, probs=probs, plan=plans[True],
                rot=rot, trans=trans, fl=fl, pp=pp, launches=launches,
                prep_launches=prep["launches"],
                fusion_launches=fused["launches"])


def texel_renderer(name, device):
    """A TexelsRenderer of scene `name` at its texels_per_pixel, and the
    scene's cameras."""
    import semantic_meshes_torch as smt

    vertices, faces, cams = scene(name)
    mesh = SimpleNamespace(vertices=vertices, faces=faces)
    return smt.render.texels(mesh, cams, TPP[name], device=device), cams


def texel_dense_vs_plain(device):
    """Phase 3, raster_dense on every view of `texels` (its reordered
    faces, at the budget its renderer probes)."""
    from semantic_meshes_torch.rasterize import dense_kernel

    renderer, cams = texel_renderer("texels", device)
    renderer.prepare(cams)
    cap = renderer.dense_cap_policy._cap[(cams[0].height, cams[0].width)]
    max_err = 0.0
    for k, cam in enumerate(cams):
        args, pargs, overflow = dense_view_pair(
            "texels", k, renderer.face_vertices, cam, cap, device)
        if args is None:
            raise AssertionError(f"texels: zero pair budget {cap}")
        zk, ik = dense_kernel.resolve_dense_cuda(*args)
        zp, ip = dense_kernel.resolve_dense_plain(*pargs)
        torch.cuda.synchronize()
        if int(overflow) != 0:
            raise AssertionError(f"texels view {k}: overflow {int(overflow)}")
        max_err = max(max_err, assert_same_image("texels", k, zk, ik, zp,
                                                 ip))
    phase(f"phase 3: dense_prep == plain chain and raster_dense == plain at "
          f"texels (reordered faces, budget {cap}): {len(cams)} views, "
          "preparations bit-equal, ids equal, depths bit-equal, overflow 0")
    return max_err


def texel_setup_check(device):
    """Phase 4: reorder_faces_for_texels and _texel_resolutions on the card
    against the same functions on the CPU at the texel presets, on every
    face. The card's reorder feeds every texel id: a difference fails the
    run."""
    from semantic_meshes_torch import geometry, render

    for name in ("texels", "texels01"):
        vertices, faces, cams = scene(name)
        out = []
        for d in (device, torch.device("cpu")):
            v = torch.as_tensor(vertices, device=d)
            f = torch.as_tensor(faces.astype(np.int64), device=d)
            out.append((geometry.reorder_faces_for_texels(v, f).cpu(),
                        render._texel_resolutions(v, f, cams,
                                                  TPP[name]).cpu()))
        (card_f, card_r), (cpu_f, cpu_r) = out
        moved = int((card_f != cpu_f).any(1).sum())
        resized = int((card_r != cpu_r).sum())
        if moved or resized:
            raise AssertionError(
                f"{name}: the card's texel setup differs from the CPU's: "
                f"{moved} faces reordered otherwise, {resized} resolutions")
        phase(f"phase 4: texel setup at {name}: reorder_faces_for_texels and "
              f"_texel_resolutions on the card equal the CPU's on all "
              f"{len(faces)} faces (0 differ)")


def texel_main_path(name, device, workdir):
    """Phase 4 at a texel preset, through the public API (texels ->
    prepare -> render -> render_many -> MeshAggregator sum/summax/mul ->
    get -> colours; fuse_views_texels under a texel plan, twice), launch
    counters read around it. Returns what phase 5 reuses."""
    import semantic_meshes_torch as smt

    sub, n_views, width, height, classes = SCENES[name]
    vertices, faces = smt.testing.make_cube(subdivisions=sub)
    path = os.path.join(workdir, f"{name}.ply")
    smt.io.ply.write_mesh(path, vertices, faces)
    mesh = smt.data.Ply(path)
    cams = smt.testing.make_ring_cameras(num_views=n_views, width=width,
                                         height=height)
    probs = device_probs(n_views, height, width, classes, device)
    rot, trans, fl, pp = smt.data.stack_cameras(cams)

    reset_launches()
    renderer = smt.render.texels(mesh, cams, TPP[name], device=device)
    P = renderer.getPrimitivesNum()
    renderer.prepare(cams)
    cap = renderer.dense_cap_policy._cap.get((height, width))
    rendered = [renderer.render(cam)[0] for cam in cams]
    many, _ = renderer.render_many(cams)
    rasterized = [cap] * (2 * n_views)
    for ids in rendered:
        if ids.dtype != torch.uint32 or tuple(ids.shape) != (width, height):
            raise AssertionError(f"render() gave {ids.dtype} {ids.shape}")
    if not torch.equal(many, torch.stack(rendered)):
        raise AssertionError(f"{name}: render_many != render")
    overflow = renderer.overflow_total()
    if overflow != 0:
        raise AssertionError(f"overflow {overflow} at {name}")
    fused_sum = fuse_and_save(name, mesh, rendered, probs, classes, workdir,
                              device, texels=P)
    plan = smt.distributed.plan_fuse(
        renderer.vertices, renderer.faces, rot, trans, fl, pp, height=height,
        width=width, allow_split=False, device=device)

    def batch():
        return smt.distributed.fuse_views_texels(
            renderer.vertices, plan.faces, renderer.resolutions,
            renderer.first_texel_index, rot, trans, fl, pp, probs, IEW,
            num_primitives=P, aggregator="sum", height=height, width=width,
            dense_e_cap=plan.dense_e_cap, device=device)

    runs = []
    for _ in range(2):
        acc, ov = batch()
        if int(ov) != 0:
            raise AssertionError(f"{name}: fuse_views_texels overflow "
                                 f"{int(ov)}")
        runs.append(acc)
    rasterized += [plan.dense_e_cap] * (2 * n_views)
    torch.cuda.synchronize()
    launches = read_launches()
    prep = read_prep()
    check_prep(name, prep, rasterized)
    # sum, summax and mul by add, then two fuse_views_texels batches
    fused = read_fusion()
    check_fusion(name, fused, 5 * n_views)
    # render, render_many and the two batches shade each view
    shaded = read_texels()
    check_texels(name, shaded, 4 * n_views)

    if not torch.equal(runs[0], runs[1]):
        raise AssertionError(f"{name}: repeated fusion is not bit-identical")
    expect = sum(1 for c in rasterized if c is not None and c.pairs > 0)
    if launches["raster_dense"] != expect or launches["raster_tile"] != 0:
        raise AssertionError(f"{name}: launches {launches} for {expect} "
                             "views rasterized with pairs")
    if not torch.allclose(runs[0], fused_sum, rtol=1e-6, atol=0.0):
        err = float((runs[0] - fused_sum).abs().max())
        raise AssertionError(f"{name}: planned != per-view (max |err| {err})")
    if P != TEXEL_P[name]:
        raise AssertionError(f"{name}: {P} texels, expected {TEXEL_P[name]}")
    ids = many.view(torch.int32)
    covered = ids >= 0
    if int(ids.max()) >= P or not covered.any():
        raise AssertionError(f"{name}: texel ids out of [0, {P})")
    r = renderer.resolutions
    if name == "texels01" and not bool((r == 1).all()):
        raise AssertionError(f"texels01: resolutions {int(r.min())}-"
                             f"{int(r.max())}, expected 1 everywhere")
    tables = (renderer.vertices, renderer.faces, renderer.resolutions,
              renderer.first_texel_index)
    cpu_tables = [t.cpu() for t in tables]
    for k, cam in enumerate(cams):
        tri = smt.rasterize.rasterize(
            renderer.vertices, renderer.faces, *cam_args(cam),
            face_vertices=renderer.face_vertices, height=height, width=width,
            dense_e_cap=cap, device=device)[0]
        # the shader on the card against the same shader on the CPU, from
        # the card's triangle ids and the renderer's tables
        card = smt.render._texel_prim_image(*tables[:2], *cam_args(cam), tri,
                                            *tables[2:], P)
        cpu = smt.render._texel_prim_image(*cpu_tables[:2], *cam_args(cam),
                                           tri.cpu(), *cpu_tables[2:], P)
        if not torch.equal(card.cpu(), cpu):
            raise AssertionError(f"{name} view {k}: the card's texel shader "
                                 f"differs from the CPU's on "
                                 f"{int((card.cpu() != cpu).sum())} pixels")
        if name == "texels01":
            # r = 1 everywhere: a pixel's texel is its triangle's first
            want = torch.where(tri >= 0, renderer.first_texel_index[
                tri.clamp(min=0).long()], -1)
            if not torch.equal(ids[k], want.t()):
                raise AssertionError(f"texels01 view {k}: texel id != "
                                     "first_texel_index[face]")
    phase(
        f"phase 4: texel path at {name} ok: {n_views} views {width}x"
        f"{height}, {len(faces)} triangles, tpp {TPP[name]}, P {P} texels "
        f"(resolution {int(r.min())}-{int(r.max())}, "
        f"{int((r == 0).sum())} triangles without texels), {classes} "
        f"classes; dense budget {cap} (render), plan {plan.dense_e_cap}; "
        f"prepare + render + render_many, "
        f"sum/summax/mul fused, colours, overflow 0, launches {launches} == "
        f"{expect} views rasterized with pairs, dense_prep {prep}, fusion "
        f"{fused}, texel kernels {shaded}, every texel id < P, the "
        f"card's shader == the CPU's on every view"
        f"{', each == first_texel_index[face]' if name == 'texels01' else ''}"
        f", fuse_views_texels == per-view (bit-equal: "
        f"{torch.equal(runs[0], fused_sum)}), repeated fusion bit-identical"
    )
    return dict(renderer=renderer, cams=cams, probs=probs, plan=plan,
                cap=cap, batch=batch, launches=launches, faces=faces,
                primitives=P, prep_launches=prep["launches"],
                fusion_launches=fused["launches"])


def texel_tile_check(device):
    """Phase 4: a texel renderer at `default` (972 faces) rasterizes through
    raster_tile: one launch per view, none of raster_dense, ids within P,
    overflow 0."""
    reset_launches()
    renderer, cams = texel_renderer("default", device)
    P = renderer.getPrimitivesNum()
    ids = torch.stack([renderer.render(cam)[0] for cam in cams]).view(
        torch.int32)
    overflow = renderer.overflow_total()
    torch.cuda.synchronize()
    launches = read_launches()
    if launches != {"raster_tile": len(cams), "raster_dense": 0}:
        raise AssertionError(f"default texels: launches {launches}")
    if overflow != 0 or int(ids.max()) >= P or not (ids >= 0).any():
        raise AssertionError(f"default texels: overflow {overflow}, ids up "
                             f"to {int(ids.max())} of {P}")
    phase(f"phase 4: texel check at default ok: {len(cams)} views through "
          f"raster_tile, launches {launches}, P {P}, ids within P, "
          "overflow 0")
    return launches


def with_lenses(cams, lenses):
    """The cameras `cams` with lens wire lenses[k] (None: none) on view k."""
    import semantic_meshes_torch as smt

    return [smt.data.Camera(c.rotation, c.translation, c.resolution,
                            c.focal_lengths, c.principal_point,
                            distortion=lens)
            for c, lens in zip(cams, lenses)]


def expect_launches(name, launches, kernel, expect):
    other = "raster_tile" if kernel == "raster_dense" else "raster_dense"
    if launches[kernel] != expect or launches[other] != 0:
        raise AssertionError(f"{name}: launches {launches}, expected "
                             f"{expect} of {kernel} and none of {other}")


def per_view_sum(P, classes, rendered, probs, device):
    """The per-view path's sum state: MeshAggregator.add of each (W, H)
    id image."""
    import semantic_meshes_torch as smt

    agg = smt.fusion.MeshAggregator(P, classes, "sum", IEW, device=device)
    for k, ids in enumerate(rendered):
        agg.add(ids, probs[k].transpose(0, 1))
    return agg.state


def same_state(name, batched, per_view):
    """batched == per-view at rtol 1e-6; returns whether bit-equal."""
    if not torch.allclose(batched, per_view, rtol=1e-6, atol=0.0):
        err = float((batched - per_view).abs().max())
        raise AssertionError(f"{name}: batched != per-view (max |err| "
                             f"{err})")
    return torch.equal(batched, per_view)


def distorted_scannet(device, workdir):
    """Phase 4 at `scannet` + SIMPLE_RADIAL (one physical camera on all 8
    views; kernel B by auto dispatch): prepare -> render -> render_many ->
    MeshAggregator sum/summax/mul -> get -> PLY; plan_fuse(distortions=)
    (lens_shared) + fuse_views_planned twice, bit-identical, == per-view;
    the hoisted grid == shared_lens=False bit for bit; overflow 0;
    raster_dense once per view rendered."""
    import semantic_meshes_torch as smt

    sub, n_views, width, height, classes = SCENES["scannet"]
    vertices, faces = smt.testing.make_cube(subdivisions=sub)
    path = os.path.join(workdir, "scannet_radial.ply")
    smt.io.ply.write_mesh(path, vertices, faces)
    mesh = smt.data.Ply(path)
    cams = with_lenses(smt.testing.make_ring_cameras(
        num_views=n_views, width=width, height=height),
        [RADIAL_SCANNET] * n_views)
    probs = device_probs(n_views, height, width, classes, device)
    rot, trans, fl, pp = smt.data.stack_cameras(cams)
    dists = smt.data.stack_distortions(cams)

    reset_launches()
    renderer = smt.render.triangles(mesh, device=device)
    renderer.prepare(cams)
    cap = renderer.dense_cap_policy._cap[(height, width)]
    rendered = [renderer.render(cam)[0] for cam in cams]
    many, _ = renderer.render_many(cams)
    if not torch.equal(many, torch.stack(rendered)):
        raise AssertionError("scannet radial: render_many != render")
    if renderer.overflow_total() != 0:
        raise AssertionError("scannet radial: render overflow")
    fused_sum = fuse_and_save("scannet_radial", mesh, rendered, probs,
                              classes, workdir, device)
    plan = smt.distributed.plan_fuse(vertices, faces, rot, trans, fl, pp,
                                     height=height, width=width,
                                     distortions=dists, device=device)
    if not plan.lens_shared:
        raise AssertionError("scannet radial: plan.lens_shared is False")
    acc = planned_twice("scannet radial", plan, vertices, cams, probs,
                        classes, device, distortions=dists)
    unhoisted, ov = smt.distributed.fuse_views_planned(
        plan, vertices, rot, trans, fl, pp, probs, IEW,
        num_primitives=len(faces), aggregator="sum", height=height,
        width=width, distortions=dists, shared_lens=False, device=device)
    torch.cuda.synchronize()
    launches = read_launches()
    if int(ov) != 0 or not torch.equal(unhoisted, acc):
        raise AssertionError("scannet radial: hoisted grid != per-view "
                             f"grids (overflow {int(ov)})")
    caps = [cap] * (2 * n_views) + [plan.dense_e_cap] * (3 * n_views)
    expect_launches("scannet radial", launches, "raster_dense",
                    sum(1 for c in caps if c.pairs > 0))
    bit = same_state("scannet radial", acc, fused_sum)
    phase(
        f"phase 4: scannet + SIMPLE_RADIAL k1 {RADIAL_SCANNET[0]} ok: "
        f"{n_views} views {width}x{height}, {len(faces)} triangles, dense "
        f"budget {cap} (render), plan {plan.dense_e_cap} lens_shared "
        f"{plan.lens_shared}; prepare + render + render_many, sum/summax/mul "
        f"fused, PLY saved and reloaded, overflow 0, launches {launches}, "
        f"planned == per-view (bit-equal: {bit}), repeated fusion "
        "bit-identical, hoisted grid == shared_lens=False bit for bit"
    )
    def batch():
        return smt.distributed.fuse_views_planned(
            plan, vertices, rot, trans, fl, pp, probs, IEW,
            num_primitives=len(faces), aggregator="sum", height=height,
            width=width, distortions=dists, device=device)

    # the same cameras and probabilities without the lens, for phase 5's
    # comparison in turns
    pinhole_plan = smt.distributed.plan_fuse(vertices, faces, rot, trans, fl,
                                             pp, height=height, width=width,
                                             device=device)

    def pinhole_batch():
        return smt.distributed.fuse_views_planned(
            pinhole_plan, vertices, rot, trans, fl, pp, probs, IEW,
            num_primitives=len(faces), aggregator="sum", height=height,
            width=width, device=device)

    return dict(faces=faces, cams=cams, plan=plan, batch=batch,
                pinhole_batch=pinhole_batch, entry="fuse_views_planned",
                launches=launches)


def distorted_large(device):
    """Phase 4 at `large` with mixed lenses (LARGE_LENSES; the tile
    rasterizer): render_many == render on one view of each nonzero lens
    (0: fisheye, 6: SIMPLE_RADIAL), the zero-lens views 4-5 of the
    distorted batch == their pinhole renders bit for bit, fuse_views
    (distortions=, no hoist) == the per-view path over render_many's
    views, overflow 0, raster_tile once per view rasterized. Every view
    of the batch, padded to the 9-wide wire, runs the extended Newton
    (~0.5-0.8 s of launches a view), so the fused batch is timed here
    once and phase 5 reuses that time."""
    import semantic_meshes_torch as smt

    sub, n_views, width, height, classes = SCENES["large"]
    vertices, faces, pinholes = scene("large")
    cams = with_lenses(pinholes, LARGE_LENSES)
    probs = device_probs(n_views, height, width, classes, device)
    rot, trans, fl, pp = smt.data.stack_cameras(cams)
    dists = smt.data.stack_distortions(cams)
    if dists.shape != (n_views, 9) or smt.distributed.lens_shared(
            fl, pp, dists):
        raise AssertionError(f"large lenses: wire {dists.shape}")

    def batch():
        return smt.distributed.fuse_views(
            vertices, faces, rot, trans, fl, pp, probs, IEW, None, dists,
            num_primitives=len(faces), aggregator="sum", height=height,
            width=width, device=device)

    reset_launches()
    renderer = smt.render.triangles(
        SimpleNamespace(vertices=vertices, faces=faces), device=device)
    single = {k: renderer.render(cams[k])[0] for k in (0, 6)}
    single.update({k: renderer.render(pinholes[k])[0] for k in (4, 5)})
    many, _ = renderer.render_many(cams)
    (acc, ov), batch_ms = timed(batch)
    launches = read_launches()
    for k, ids in single.items():
        if not torch.equal(many[k], ids):
            raise AssertionError(
                f"large lenses: view {k} of render_many != its "
                + ("pinhole render" if k in (4, 5) else "render"))
    if renderer.overflow_total() != 0 or int(ov) != 0:
        raise AssertionError(f"large lenses: overflow {int(ov)}")
    # the four single renders, render_many, the batch
    expect_launches("large lenses", launches, "raster_tile",
                    len(single) + 2 * n_views)
    bit = same_state("large lenses", acc,
                     per_view_sum(len(faces), classes, many, probs, device))
    phase(
        f"phase 4: large + lenses ok: {n_views} views {width}x{height} "
        f"(fisheye {FISHEYE[:4]} on views 0-3, zero 4-5, SIMPLE_RADIAL k1 "
        f"{RADIAL_LARGE[0]} 6-7; wire {dists.shape}, no hoist), "
        f"{len(faces)} triangles; render_many == render on views 0 and 6, "
        f"zero-lens views 4-5 == pinhole bit for bit, fuse_views == "
        f"per-view (bit-equal: {bit}), overflow 0, launches {launches}"
    )
    return dict(faces=faces, cams=cams, batch=batch, batch_ms=batch_ms,
                entry="fuse_views", renderer=renderer, launches=launches)


def distorted_texels(device):
    """Phase 4: the `default` texel renderer (2.0 texels per pixel) under
    `large`'s lens pattern: through raster_tile, and forced through
    raster_dense (backend="dense" on fuse_views_texels and the renderer):
    fuse_views_texels(distortions=) == the per-view path, every texel id
    < P, overflow 0, each kernel once per view rasterized and the other
    not at all. Each fused batch is timed here once (phase 5 reuses the
    time), as at `large` + lenses."""
    import semantic_meshes_torch as smt

    sub, n_views, width, height, classes = SCENES["default"]
    vertices, faces, pinholes = scene("default")
    mesh = SimpleNamespace(vertices=vertices, faces=faces)
    cams = with_lenses(pinholes, LARGE_LENSES)
    probs = device_probs(n_views, height, width, classes, device)
    rot, trans, fl, pp = smt.data.stack_cameras(cams)
    dists = smt.data.stack_distortions(cams)
    out = {}
    for backend in ("tile", "dense"):
        reset_launches()
        renderer = smt.render.texels(mesh, pinholes, TPP["default"],
                                     backend=backend, device=device)
        P = renderer.getPrimitivesNum()
        renderer.prepare(cams)
        rendered = [renderer.render(cam)[0] for cam in cams]
        plan = smt.distributed.plan_fuse(
            renderer.vertices, renderer.faces, rot, trans, fl, pp,
            height=height, width=width, backend=backend, allow_split=False,
            distortions=dists, device=device)

        def batch(renderer=renderer, plan=plan, backend=backend, P=P):
            return smt.distributed.fuse_views_texels(
                renderer.vertices, renderer.faces, renderer.resolutions,
                renderer.first_texel_index, rot, trans, fl, pp, probs, IEW,
                distortions=dists, num_primitives=P, aggregator="sum",
                height=height, width=width, backend=backend,
                dense_e_cap=plan.dense_e_cap, device=device)

        (acc, ov), batch_ms = timed(batch)
        launches = read_launches()
        ids = torch.stack(rendered).view(torch.int32)
        if int(ov) != 0 or renderer.overflow_total() != 0:
            raise AssertionError(f"default texels lenses {backend}: overflow")
        if int(ids.max()) >= P or not (ids >= 0).any():
            raise AssertionError(f"default texels lenses {backend}: ids up "
                                 f"to {int(ids.max())} of {P}")
        kernel = "raster_tile" if backend == "tile" else "raster_dense"
        expect_launches(f"default texels lenses {backend}", launches, kernel,
                        2 * n_views)
        bit = same_state(f"default texels lenses {backend}", acc,
                         per_view_sum(P, classes, rendered, probs, device))
        phase(
            f"phase 4: default texels + lenses through {kernel} ok: "
            f"{n_views} views {width}x{height}, tpp {TPP['default']}, P {P}, "
            f"lenses as at large, plan {plan.dense_e_cap}; "
            f"fuse_views_texels(distortions=, backend={backend!r}) == "
            f"per-view (bit-equal: {bit}), every texel id < P, overflow 0, "
            f"launches {launches}"
        )
        out[backend] = dict(batch=batch, batch_ms=batch_ms,
                            entry="fuse_views_texels", launches=launches,
                            primitives=P, faces=faces, plan=plan)
    return out


def grid_card_vs_cpu(device, card):
    """Phase 4: _undistort_grid on the card against the CPU, one view per
    lens, from the same inputs: the classic wire bit for bit (a gate);
    the extended wire's max |dn| and |ds|, and the card's own pinhole
    image resampled with the CPU grid against the card grid (ids may
    differ on at most 1e-4 of the pixels). The extended view is the
    fisheye grid of `default` texels + lenses at its full 1024x768:
    `large`'s 2048x1536 has the same lens and field of view (focal 0.9 x
    height, centred) and runs the same elementwise ops on 4x the pixels,
    where the CPU's Newton would take 4x the time printed here."""
    import semantic_meshes_torch as smt
    from semantic_meshes_torch import rasterize as rast, render

    views = [("scannet", SCENES["scannet"], RADIAL_SCANNET),
             ("large", SCENES["large"], RADIAL_LARGE),
             ("default", SCENES["default"], FISHEYE)]
    for label, (sub, n, width, height, _), lens in views:
        vertices, faces = smt.testing.make_cube(subdivisions=sub)
        cam = smt.testing.make_ring_cameras(num_views=n, width=width,
                                            height=height)[0]
        out = []
        for d in (device, torch.device("cpu")):
            fl, pp, dist = (torch.as_tensor(np.asarray(a, np.float32),
                                            device=d)
                            for a in (cam.focal_lengths,
                                      cam.principal_point, lens))
            t = time.monotonic()
            out.append(render._undistort_grid(fl, pp, dist, height=height,
                                              width=width))
        cpu_s = time.monotonic() - t
        (n_card, s_card), (n_cpu, s_cpu) = out
        bit = torch.equal(n_card.cpu(), n_cpu) and torch.equal(
            s_card.cpu(), s_cpu)
        fl_s = torch.as_tensor(cam.focal_lengths, device=device) * s_card
        pp = torch.as_tensor(cam.principal_point, device=device)
        tri, depth, _ = rast.rasterize(
            torch.as_tensor(vertices, device=device),
            torch.as_tensor(faces.astype(np.int64), device=device),
            cam.rotation, cam.translation, fl_s, pp, height=height,
            width=width, backend="dense" if len(faces) >= 16384 else "tile",
            device=device)
        ids_card, _ = render._resample_wh(tri.t(), depth.t(), n_card, fl_s,
                                          pp)
        ids_cpu, _ = render._resample_wh(tri.t(), depth.t(),
                                         n_cpu.to(device), fl_s, pp)
        differ = int((ids_card != ids_cpu).sum())
        dn = float((n_card.cpu() - n_cpu).abs().max())
        ds = abs(float(s_card) - float(s_cpu))
        classic = len(lens) == 4
        if (classic and not bit) or differ > 1e-4 * width * height:
            raise AssertionError(
                f"{label}: card grid != CPU grid (bit-equal {bit}, max |dn| "
                f"{dn}, |ds| {ds}, {differ} ids differ)")
        phase(f"phase 4 [{card}]: grid card vs CPU at {label} {width}x"
              f"{height}, lens {list(lens)}: bit-equal {bit}, max |dn| {dn}, "
              f"|ds| {ds} (s {float(s_card)}), ids differing after the "
              f"resample {differ} of {width * height}; the CPU grid took "
              f"{cpu_s:.3f} s")


def lens_times(large_ctx, scannet_ctx, device, card):
    """Phase 5 of the distorted paths, per view: the grid (classic at
    `scannet`, hoisted: once per batch; extended at `large`, per view),
    launched from Python; _resample_wh at `large` launched and in graph
    replays, with the bound of its bytes."""
    from semantic_meshes_torch import rasterize as rast, render

    def grid_args(cam, lens):
        return [torch.as_tensor(np.asarray(a, np.float32), device=device)
                for a in (cam.focal_lengths, cam.principal_point, lens)]

    cam = scannet_ctx["cams"][0]
    width, height = cam.resolution
    args = grid_args(cam, cam.distortion)
    classic_ms = cuda_time_ms(lambda: render._undistort_grid(
        *args, height=height, width=width), reps=5)
    cam = large_ctx["cams"][0]
    lw, lh = cam.resolution
    args = grid_args(cam, cam.distortion)
    # one run: phase 4 has run this grid's launches many times already
    (grid, s), ext_ms = timed(lambda: render._undistort_grid(
        *args, height=lh, width=lw))
    fl_s = args[0] * s
    renderer = large_ctx["renderer"]
    tri, depth, _ = rast.rasterize(
        renderer.vertices, renderer.faces, cam.rotation, cam.translation,
        fl_s, args[1], face_vertices=renderer.face_vertices, height=lh,
        width=lw, device=device)
    ids_wh, depth_wh = tri.t(), depth.t()

    def resample():
        return render._resample_wh(ids_wh, depth_wh, grid, fl_s, args[1])

    resample_ms = cuda_time_ms(resample, reps=20)
    resample_graph_ms = graph_time_ms(resample, reps=20)
    # each input read once (grid 8 B, id + depth 8 B a pixel), each output
    # written once (id + depth 8 B)
    nbytes = lw * lh * 24
    bound_ms = nbytes / PEAK_BYTES_S * 1e3
    n_views = len(scannet_ctx["cams"])
    phase(
        f"phase 5 [{card}]: lens pieces, launched from Python: the classic "
        f"grid (SIMPLE_RADIAL) at scannet {width}x{height} {classic_ms:.6f} "
        f"ms once per batch ({classic_ms / n_views:.6f} ms per view of "
        f"{n_views}, hoisted); the extended grid (fisheye) at large "
        f"{lw}x{lh} {ext_ms:.6f} ms per view; _resample_wh at large "
        f"{resample_ms:.6f} ms launched, {resample_graph_ms:.6f} ms in graph "
        f"replays, its bytes bound {bound_ms:.6f} ms for {nbytes} bytes"
    )


def indoor_scene(name):
    """Preset `name`'s mesh, views and classes with the cameras moved
    inside: the cube at ROOM_SIZE and the views on INDOOR_RING."""
    from semantic_meshes_torch import testing

    sub, views, width, height, _ = SCENES[name]
    vertices, faces = testing.make_cube(subdivisions=sub, size=ROOM_SIZE)
    cams = testing.make_ring_cameras(num_views=views, width=width,
                                     height=height, **INDOOR_RING)
    return vertices, faces, cams


def straddle_scene():
    """tests/test_clipping.py's random straddling scene at `scannet`'s
    1296x968: 40 vertices N(0, 1) x 2 and 30 faces from seed 8, many
    across the camera plane; the camera at the origin looking down +z,
    focal 0.9 x 968, centred."""
    from semantic_meshes_torch import data

    rng = np.random.default_rng(8)
    vertices = rng.normal(size=(40, 3)).astype(np.float32) * 2
    faces = rng.integers(0, 40, size=(30, 3)).astype(np.int32)
    cam = data.Camera(np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                      (1296, 968), np.full(2, 0.9 * 968, np.float32),
                      np.array([648.0, 484.0], np.float32))
    return vertices, faces, cam


def global_drops(vertices, faces, cams, device, lenses=None):
    """Per view, the big rows of the clipped setup past dense.N_GLOBAL:
    the rows a direct dense call at the JAX package's fixed cap drops and
    counts in overflow, from the classification alone, independent of the
    kernel (the renderers and plans size n_global past them). lenses:
    per-view lens wires; the setup then runs under the virtual focal, as
    the render does."""
    from semantic_meshes_torch import render
    from semantic_meshes_torch.rasterize import dense, tiles

    fv = face_vertices(vertices, faces, device)
    out = []
    for k, cam in enumerate(cams):
        fl = torch.as_tensor(cam.focal_lengths, device=device)
        if lenses is not None:
            fl = fl * render._undistort_grid(
                fl, torch.as_tensor(cam.principal_point, device=device),
                torch.as_tensor(np.asarray(lenses[k], np.float32),
                                device=device),
                height=cam.height, width=cam.width)[1]
        setup = tiles.setup_inputs(None, None, cam.rotation, cam.translation,
                                   fl, cam.principal_point, face_vertices=fv,
                                   device=device, clip_near=True)
        big = dense._classify(setup, cam.height, cam.width, 0.0)[2]
        out.append(max(int(big.sum()) - dense.N_GLOBAL, 0))
    return out


def check_coverage(label, ids, drops):
    """Every pixel of every view without global-bucket drops is covered (a
    closed room); returns the coverage per view (W, H) id images."""
    cov = [float((i.view(torch.int32) >= 0).double().mean()) for i in ids]
    for k, (c, d) in enumerate(zip(cov, drops)):
        if d == 0 and c != 1.0:
            raise AssertionError(f"{label} view {k}: coverage {c} in a "
                                 "closed room")
    return cov


def clipped_vs_plain(device):
    """Phase 3 on the 2T clipped piece rows (pieces pinned at z = 1e-4
    project up to ~1e4 x the focal, so edge constants reach ~1e13): both
    kernels (raster_dense forced) on the straddling scene, raster_tile on
    every view of `large` indoor, raster_dense on every view of `scannet`
    indoor at the budget its clipped renderer probes, with the JAX
    package's fixed n_global (twice per view, bit-identical). Returns the
    largest |depth difference|."""
    from semantic_meshes_torch.rasterize import dense, dense_kernel, \
        tile_kernel

    max_err = 0.0
    vertices, faces, cam = straddle_scene()
    fv = face_vertices(vertices, faces, device)
    args, ov_t = view_inputs(fv, cam, device, clip_near=True)
    zk, ik = tile_kernel.resolve_tiles_cuda(*args)
    zp, ip = tile_kernel.resolve_tiles_plain(*args)
    dargs, pdargs, ov_d = dense_view_pair("straddle", 0, fv, cam, None,
                                          device, clip_near=True)
    zd, idd = dense_kernel.resolve_dense_cuda(*dargs)
    zdp, idp = dense_kernel.resolve_dense_plain(*pdargs)
    torch.cuda.synchronize()
    max_err = max(max_err, assert_same_image("straddle tile", 0, zk, ik, zp,
                                             ip),
                  assert_same_image("straddle dense", 0, zd, idd, zdp, idp))
    if not torch.equal(ik, idd) or int(ov_t) or int(ov_d):
        raise AssertionError("straddle: raster_tile and raster_dense differ "
                             f"(overflow {int(ov_t)}, {int(ov_d)})")
    phase(f"phase 3: raster_tile and raster_dense (forced) == plain on the "
          f"straddling scene ({len(faces)} faces, {args[0].shape[0] - 1} "
          f"piece rows, {cam.width}x{cam.height}, coverage "
          f"{float((ik >= 0).float().mean()):.6f}): ids equal, depths "
          "bit-equal, the two kernels' piece ids equal, overflow 0")

    vertices, faces, cams = indoor_scene("large")
    fv = face_vertices(vertices, faces, device)
    for k, cam in enumerate(cams):
        args, overflow = view_inputs(fv, cam, device, clip_near=True)
        zk, ik = tile_kernel.resolve_tiles_cuda(*args)
        zp, ip = tile_kernel.resolve_tiles_plain(*args)
        torch.cuda.synchronize()
        if int(overflow):
            raise AssertionError(f"large indoor view {k}: overflow")
        max_err = max(max_err, assert_same_image("large indoor", k, zk, ik,
                                                 zp, ip))
    phase(f"phase 3: raster_tile == plain at large indoor + clip: "
          f"{len(cams)} views, {2 * len(faces)} piece rows, ids equal, "
          "depths bit-equal, overflow 0")

    vertices, faces, cams = indoor_scene("scannet")
    fv = face_vertices(vertices, faces, device)
    # the clipped renderer's budget at the JAX package's fixed global cap
    cap = dataclasses.replace(
        dense_budget(vertices, faces, cams, device, clip_near=True),
        n_global=dense.N_GLOBAL)
    drops = global_drops(vertices, faces, cams, device)
    shapes = []
    for k, cam in enumerate(cams):
        args, pargs, overflow = dense_view_pair("scannet indoor", k, fv, cam,
                                                cap, device, clip_near=True)
        if args is None:
            raise AssertionError(f"scannet indoor: zero pair budget {cap}")
        zk, ik = dense_kernel.resolve_dense_cuda(*args)
        z2, i2 = dense_kernel.resolve_dense_cuda(*args)
        zp, ip = dense_kernel.resolve_dense_plain(*pargs)
        torch.cuda.synchronize()
        if not (torch.equal(i2, ik) and torch.equal(z2.view(torch.int32),
                                                    zk.view(torch.int32))):
            raise AssertionError(f"scannet indoor view {k}: two runs of "
                                 "raster_dense differ")
        if int(overflow) != drops[k]:
            raise AssertionError(f"scannet indoor view {k}: overflow "
                                 f"{int(overflow)}, expected {drops[k]}")
        max_err = max(max_err, assert_same_image("scannet indoor", k, zk, ik,
                                                 zp, ip))
        starts = args[2].long()
        B = starts.numel() - 2
        shapes.append((int(starts[B + 1] - starts[B]),
                       int((starts[1:B + 1] - starts[:B]).max())))
    phase(f"phase 3: dense_prep == plain chain and raster_dense == plain at "
          f"scannet indoor + clip (budget {cap}, {2 * len(faces)} piece "
          f"rows): {len(cams)} views, preparations bit-equal, ids "
          f"equal, depths bit-equal, two runs per view bit-identical, "
          f"overflow per view == big rows past n_global {drops}; (global "
          f"bucket, heaviest own range) per view {shapes}")
    return max_err


def indoor_main_path(name, device, workdir):
    """Phase 4 at `scannet` or `large` indoor, clip_near=True, through the
    public API, launch counters read around it: prepare -> render ->
    render_many -> MeshAggregator sum/summax/mul -> get -> colours -> PLY;
    plan_fuse(clip_near=True) compacts (split_k 0, remap None);
    fuse_views_planned twice, bit-identical, == per-view; fuse_views_split
    == fuse_views at the plan's n_global; overflow 0 everywhere: the
    renderer's probe and the plan size n_global past the big rows that a
    direct call at dense.N_GLOBAL drops (global_drops); every pixel
    covered in every view (a closed room); the kernel once per view
    rasterized with pairs. Returns what phase 5 reuses, with the same cameras' culled
    batch."""
    import semantic_meshes_torch as smt

    sub, n_views, width, height, classes = SCENES[name]
    label = f"{name} indoor + clip"
    vertices, faces, cams = indoor_scene(name)
    path = os.path.join(workdir, f"{name}_indoor.ply")
    smt.io.ply.write_mesh(path, vertices, faces)
    mesh = smt.data.Ply(path)
    probs = device_probs(n_views, height, width, classes, device)
    rot, trans, fl, pp = smt.data.stack_cameras(cams)
    dense = smt.rasterize.uses_dense(None, len(faces))
    kw = dict(num_primitives=len(faces), aggregator="sum", height=height,
              width=width, clip_near=True, device=device)
    drops = (global_drops(vertices, faces, cams, device) if dense
             else [0] * n_views)
    total = sum(drops)

    reset_launches()
    renderer = smt.render.triangles(mesh, clip_near=True, device=device)
    renderer.prepare(cams)
    cap = renderer.dense_cap_policy._cap.get((height, width))
    rendered = [renderer.render(cam)[0] for cam in cams]
    many, _ = renderer.render_many(cams)
    if not torch.equal(many, torch.stack(rendered)):
        raise AssertionError(f"{label}: render_many != render")
    if renderer.overflow_total():
        raise AssertionError(f"{label}: render overflow "
                             f"{renderer.overflow_total()}, expected 0")
    coverage = check_coverage(label, many, [0] * n_views)
    fused_sum = fuse_and_save(f"{name}_indoor", mesh, rendered, probs,
                              classes, workdir, device)
    plan = smt.distributed.plan_fuse(vertices, faces, rot, trans, fl, pp,
                                     height=height, width=width,
                                     clip_near=True, device=device)
    if (plan.dense_e_cap is not None and plan.dense_e_cap.split_k != 0
            or plan.remap is not None):
        raise AssertionError(f"{label}: plan {plan.dense_e_cap} split")
    acc = planned_twice(label, plan, vertices, cams, probs, classes, device,
                        clip_near=True)
    # default budgets at the plan's global cap
    default = smt.rasterize.dense.DenseBudget(
        n_global=plan.dense_e_cap.n_global) if dense else None
    unplanned, ov = smt.distributed.fuse_views(vertices, faces, rot, trans,
                                               fl, pp, probs, IEW,
                                               dense_e_cap=default, **kw)
    split, ov_s = smt.distributed.fuse_views_split(vertices, faces, rot,
                                                   trans, fl, pp, probs, IEW,
                                                   **kw)
    torch.cuda.synchronize()
    launches = read_launches()
    if int(ov) or int(ov_s) or not torch.equal(split, unplanned):
        raise AssertionError(f"{label}: fuse_views_split != fuse_views "
                             f"(overflow {int(ov)}, {int(ov_s)})")
    # render, render_many, two planned batches, fuse_views (default
    # budgets: always binned), fuse_views_split (the plan's budgets)
    caps = ([cap] * (2 * n_views) + [plan.dense_e_cap] * (2 * n_views)
            + [None] * n_views + [plan.dense_e_cap] * n_views)
    kernel = "raster_dense" if dense else "raster_tile"
    expect_launches(label, launches, kernel, sum(
        1 for c in caps if not dense or c is None or c.pairs > 0))
    prep = read_prep()
    check_prep(label, prep, caps if dense else [])
    bit = same_state(label, acc, fused_sum)
    if not torch.equal(unplanned, acc):
        raise AssertionError(f"{label}: fuse_views != fuse_views_planned")
    extra = (f"dense budget {cap} (render), plan {plan.dense_e_cap}"
             if dense else "tile rasterizer")
    phase(
        f"phase 4: {label} ok: {n_views} views {width}x{height} inside a "
        f"{ROOM_SIZE} m room, {len(faces)} triangles, {classes} classes, "
        f"{extra}; prepare + render + render_many, "
        f"coverage per view {coverage}, sum/summax/mul fused, PLY saved and "
        f"reloaded, overflow 0 (a direct call at N_GLOBAL drops {total}: "
        f"{drops} a view), launches {launches}, dense_prep {prep}, planned "
        f"== per-view "
        f"(bit-equal: {bit}), repeated fusion bit-identical, "
        "fuse_views_split == fuse_views == planned"
    )

    def batch():
        return smt.distributed.fuse_views_planned(
            plan, vertices, rot, trans, fl, pp, probs, IEW, **kw)

    cull_plan = smt.distributed.plan_fuse(vertices, faces, rot, trans, fl,
                                          pp, height=height, width=width,
                                          device=device)

    def cull_batch():
        return smt.distributed.fuse_views_planned(
            cull_plan, vertices, rot, trans, fl, pp, probs, IEW,
            **dict(kw, clip_near=False))

    return dict(faces=faces, vertices=vertices, cams=cams, probs=probs,
                plan=plan, batch=batch, cull_batch=cull_batch,
                entry="fuse_views_planned", launches=launches, cap=cap,
                drops=drops, prep_launches=prep["launches"])


def indoor_texels01(device):
    """Phase 4 at `texels01` indoor (`scannet` indoor's mesh, views and
    classes at 0.1 texels per pixel, clip_near=True): the clipped
    _texel_resolutions on the card == the CPU's on every face; texels ->
    prepare -> render -> render_many -> MeshAggregator sum/summax/mul ->
    get -> colours; fuse_views_texels(clip_near=True) under
    plan_fuse(allow_split=False, clip_near=True) twice, bit-identical,
    == per-view; every id < P; overflow 0 (n_global sized past the big
    rows a direct call at dense.N_GLOBAL drops, global_drops); the card's
    ray-form shader ==
    the CPU's bit for bit on every view, from the card's triangle ids;
    raster_dense once per view rasterized with pairs."""
    import semantic_meshes_torch as smt
    from semantic_meshes_torch import render

    sub, n_views, width, height, classes = SCENES["texels01"]
    label = "texels01 indoor + clip"
    tpp = TPP["texels01"]
    vertices, faces, cams = indoor_scene("texels01")
    sizes = []
    for d in (device, torch.device("cpu")):
        v = torch.as_tensor(vertices, device=d)
        f = torch.as_tensor(faces.astype(np.int64), device=d)
        sizes.append(render._texel_resolutions(v, f, cams, tpp,
                                               clip_near=True).cpu())
    resized = int((sizes[0] != sizes[1]).sum())
    if resized:
        raise AssertionError(f"{label}: the card's clipped sizing differs "
                             f"from the CPU's on {resized} faces")
    mesh = SimpleNamespace(vertices=vertices, faces=faces)
    probs = device_probs(n_views, height, width, classes, device)
    rot, trans, fl, pp = smt.data.stack_cameras(cams)
    drops = global_drops(vertices, faces, cams, device)
    total = sum(drops)

    reset_launches()
    renderer = smt.render.texels(mesh, cams, tpp, clip_near=True,
                                 device=device)
    P = renderer.getPrimitivesNum()
    if not torch.equal(renderer.resolutions.cpu(), sizes[1]):
        raise AssertionError(f"{label}: renderer sizing != the CPU's")
    renderer.prepare(cams)
    cap = renderer.dense_cap_policy._cap[(height, width)]
    rendered = [renderer.render(cam)[0] for cam in cams]
    many, _ = renderer.render_many(cams)
    if not torch.equal(many, torch.stack(rendered)):
        raise AssertionError(f"{label}: render_many != render")
    if renderer.overflow_total():
        raise AssertionError(f"{label}: render overflow "
                             f"{renderer.overflow_total()}, expected 0")
    fused_sum = fuse_and_save(label, mesh, rendered, probs, classes, None,
                              device, texels=P)
    plan = smt.distributed.plan_fuse(
        renderer.vertices, renderer.faces, rot, trans, fl, pp, height=height,
        width=width, allow_split=False, clip_near=True, device=device)

    def batch():
        return smt.distributed.fuse_views_texels(
            renderer.vertices, plan.faces, renderer.resolutions,
            renderer.first_texel_index, rot, trans, fl, pp, probs, IEW,
            num_primitives=P, aggregator="sum", height=height, width=width,
            clip_near=True, dense_e_cap=plan.dense_e_cap, device=device)

    runs = []
    for _ in range(2):
        acc, ov = batch()
        if int(ov):
            raise AssertionError(f"{label}: fuse_views_texels overflow "
                                 f"{int(ov)}, expected 0")
        runs.append(acc)
    torch.cuda.synchronize()
    launches = read_launches()
    if not torch.equal(runs[0], runs[1]):
        raise AssertionError(f"{label}: repeated fusion is not "
                             "bit-identical")
    caps = [cap] * (2 * n_views) + [plan.dense_e_cap] * (2 * n_views)
    expect_launches(label, launches, "raster_dense",
                    sum(1 for c in caps if c.pairs > 0))
    bit = same_state(label, runs[0], fused_sum)
    ids = many.view(torch.int32)
    if int(ids.max()) >= P:
        raise AssertionError(f"{label}: texel ids out of [0, {P})")
    tables = (renderer.vertices, renderer.faces, renderer.resolutions,
              renderer.first_texel_index)
    cpu_tables = [t.cpu() for t in tables]
    for k, cam in enumerate(cams):
        tri = smt.rasterize.rasterize(
            renderer.vertices, renderer.faces, *cam_args(cam),
            face_vertices=renderer.face_vertices, height=height, width=width,
            clip_near=True, dense_e_cap=cap, device=device)[0]
        card = render._texel_prim_image(*tables[:2], *cam_args(cam), tri,
                                        *tables[2:], P, clip_near=True)
        cpu = render._texel_prim_image(*cpu_tables[:2], *cam_args(cam),
                                       tri.cpu(), *cpu_tables[2:], P,
                                       clip_near=True)
        if not torch.equal(card.cpu(), cpu):
            raise AssertionError(f"{label} view {k}: the card's ray-form "
                                 f"shader differs from the CPU's on "
                                 f"{int((card.cpu() != cpu).sum())} pixels")
    r = renderer.resolutions
    cull = render._texel_resolutions(
        torch.as_tensor(vertices, device=device),
        torch.as_tensor(faces.astype(np.int64), device=device), cams, tpp)
    phase(
        f"phase 4: {label} ok: {n_views} views {width}x{height}, "
        f"{len(faces)} triangles, tpp {tpp}, P {P} texels (culled sizing "
        f"{int(smt.geometry.texel_count(cull.long()).sum())}; resolution "
        f"{int(r.min())}-{int(r.max())}, {int((r == 0).sum())} triangles "
        f"without texels, {int((r > 0).sum() - (cull > 0).sum())} more "
        f"sized than by the culled rule), the card's clipped sizing == the "
        f"CPU's on every face; dense budget {cap} (render), plan "
        f"{plan.dense_e_cap}; prepare + render + render_many, sum/summax/mul "
        f"fused, texel coverage {float((ids >= 0).double().mean())}, every "
        f"id < P, overflow 0 (a direct call at N_GLOBAL drops {total}: "
        f"{drops} a view), launches {launches}, the card's ray-form "
        f"shader == the CPU's on every view, fuse_views_texels == per-view "
        f"(bit-equal: {bit}), repeated fusion bit-identical"
    )
    return dict(faces=faces, primitives=P, probs=probs, plan=plan,
                batch=batch, entry="fuse_views_texels", launches=launches)


def indoor_scannet_lens(device):
    """Phase 4 at `scannet` indoor + SIMPLE_RADIAL k1 = RADIAL_SCANNET[0]
    on all views (clip_near=True, kernel B): render_many == per-view
    render, clipped under the virtual focal; overflow 0 (the probe under
    that focal sizes n_global past the big rows a direct call at
    dense.N_GLOBAL drops, global_drops); raster_dense once per view
    rendered with pairs."""
    import semantic_meshes_torch as smt

    label = "scannet indoor + clip + SIMPLE_RADIAL"
    vertices, faces, pinholes = indoor_scene("scannet")
    cams = with_lenses(pinholes, [RADIAL_SCANNET] * len(pinholes))
    drops = global_drops(vertices, faces, cams, device,
                         [RADIAL_SCANNET] * len(cams))
    reset_launches()
    renderer = smt.render.triangles(
        SimpleNamespace(vertices=vertices, faces=faces), clip_near=True,
        device=device)
    renderer.prepare(cams)
    cap = renderer.dense_cap_policy._cap[cams[0].height, cams[0].width]
    rendered = [renderer.render(cam)[0] for cam in cams]
    many, _ = renderer.render_many(cams)
    torch.cuda.synchronize()
    launches = read_launches()
    if not torch.equal(many, torch.stack(rendered)):
        raise AssertionError(f"{label}: render_many != render")
    if renderer.overflow_total():
        raise AssertionError(f"{label}: overflow {renderer.overflow_total()}"
                             ", expected 0")
    expect_launches(label, launches, "raster_dense",
                    2 * len(cams) if cap.pairs > 0 else 0)
    coverage = [float((i.view(torch.int32) >= 0).double().mean())
                for i in many]
    phase(f"phase 4: {label} ok: {len(cams)} views, dense budget {cap} "
          f"under the virtual focal; render_many == render, coverage per "
          f"view {coverage}, overflow 0 (a direct call at N_GLOBAL drops "
          f"{sum(drops)}: {drops} a view), launches {launches}")
    return dict(launches=launches)


def clip_times(ctx, device, card):
    """Phase 5 at `scannet` indoor, per view: the near-plane clipper
    (geometry.clip_triangles_near) and the whole clipped setup
    (tiles.setup_clipped: rigid transform, clipper, projection, setup of
    the 2T rows) against the culled setup of the same cameras, each
    launched from Python and in CUDA-graph replays."""
    from semantic_meshes_torch import geometry
    from semantic_meshes_torch.rasterize import tiles

    cams, faces = ctx["cams"], ctx["faces"]
    fv = face_vertices(ctx["vertices"], faces, device)
    cam_t = [tuple(torch.as_tensor(np.asarray(a, np.float32), device=device)
                   for a in cam_args(c)) for c in cams]
    n = len(cams)

    def clipper():
        return [geometry.clip_triangles_near(
            geometry.rigid_transform(r, t, fv), tiles.CLIP_Z_NEAR)
            for r, t, _, _ in cam_t]

    def clipped():
        return [tiles.setup_clipped(fv, *c) for c in cam_t]

    def culled():
        return [tiles.setup_from_face_vertices(fv, *c) for c in cam_t]

    out = {}
    for label, fn in (("clipper", clipper), ("clipped setup", clipped),
                      ("culled setup", culled)):
        out[label] = (cuda_time_ms(fn, reps=10) / n,
                      graph_time_ms(fn, reps=10) / n)
    phase(
        f"phase 5 [{card}]: scannet indoor + clip ({n} views, {len(faces)} "
        f"faces), per view launched / in graph replays: "
        + "; ".join(f"{k} {a:.6f} / {b:.6f} ms" for k, (a, b) in out.items())
    )
    return out


def bound(ops, nbytes, ops_per_s=PEAK_FP32_OPS):
    ops_ms = ops / ops_per_s * 1e3
    bytes_ms = nbytes / PEAK_BYTES_S * 1e3
    return (max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms
            else "bytes", ops_ms, bytes_ms)


def in_turns(fns, inputs, reps):
    """Per-view ms of each function in `fns` (name -> function of one
    view's arguments) over all `inputs` back to back, timed in turns a, b,
    ..., ..., b, a: each turn takes `ms` (graph_time_ms) and `launched_ms`
    (CUDA events around Python launching the views one by one), medians
    of `reps`. Returns name -> {"ms": [two turns], "launched_ms": [...]}."""
    order = list(fns) + list(reversed(list(fns)))
    out = {name: {"ms": [], "launched_ms": []} for name in fns}
    for name in order:
        fn = fns[name]

        def all_views():
            return [fn(*a) for a in inputs]

        out[name]["ms"].append(graph_time_ms(all_views, reps) / len(inputs))
        out[name]["launched_ms"].append(cuda_time_ms(all_views, reps)
                                        / len(inputs))
    return out


def turn_means(turns, keys=("ms", "launched_ms")):
    return {k: statistics.mean(turns[k]) for k in keys}


def against_entry(against, *turn_sets):
    """The kernel line's "against" entry: per --against label, the means
    of its turns (one dict of turns per measurement)."""
    if not against:
        return {}
    return {"against": {label: dict(kv for t in turn_sets
                                    for kv in t(label).items())
                        for label in against}}


def tile_counts_only(args, keep):
    """resolve_tiles arguments of one view with every tile's count set to
    0, except the heaviest tile's when `keep`."""
    table, cand, counts, *rest = args
    new = torch.zeros_like(counts)
    if keep:
        b = int(counts.argmax())
        new[b] = counts[b]
    return (table, cand, new, *rest)


def rect_meets(args):
    """Per view, from the table: the (candidate, warp rectangle) pairs
    whose three edge forms pass the corner test at the rectangle (the
    kernel's cull without its depth test; a warp owns 16 columns x 8
    rows), and the most of them any one rectangle has. Forms are rounded
    op by op, as the kernels do."""
    cols, rows = 16, 8
    table, cand, counts, y_offset, nbx, _, _ = args
    B, N = cand.shape
    params = table[cand.long()]  # (B, N, 16)
    live = torch.arange(N, device=cand.device)[None, :] < counts[:, None]
    b = torch.arange(B, device=cand.device)
    r = torch.arange(32 * 128 // (cols * rows), device=cand.device)
    x0 = ((b % nbx) * 128)[:, None] + (r % (128 // cols)) * cols
    y0 = ((b // nbx) * 32)[:, None] + (r // (128 // cols)) * rows
    pxl = x0.to(torch.float32) + 0.5
    pxh = (x0 + cols - 1).to(torch.float32) + 0.5
    pyl = (y0.to(torch.float32) + 0.5) + y_offset
    pyh = ((y0 + rows - 1).to(torch.float32) + 0.5) + y_offset
    meets = live[:, :, None]
    for e in range(3):
        a = params[:, :, 3 * e, None]
        bb = params[:, :, 3 * e + 1, None]
        c = params[:, :, 3 * e + 2, None]
        px = torch.where(a >= 0, pxh[:, None, :], pxl[:, None, :])
        py = torch.where(bb >= 0, pyh[:, None, :], pyl[:, None, :])
        meets = meets & ~((a * px + bb * py) + c < 0)  # (B, N, R)
    return int(meets.sum()), int(meets.sum(1).max())


def tile_times(name, device, card, against, clip=False):
    """raster_tile and its plain version at scene `name` (clip: its indoor
    variant, clipped): ms per view (the kernel's in turns with each
    --against copy's, by in_turns, on the view, on its heaviest tile alone
    and with every tile empty; the plain version's by CUDA events around
    all views back to back), with the bound of one view's work computed
    from this run's inputs."""
    from semantic_meshes_torch.rasterize import tile_kernel

    vertices, faces, cams = (indoor_scene if clip else scene)(name)
    n_views = len(cams)
    width, height = cams[0].resolution
    fv = face_vertices(vertices, faces, device)
    inputs = [view_inputs(fv, cam, device, clip_near=clip)[0]
              for cam in cams]
    sum_counts = [int(a[2].sum()) for a in inputs]
    max_counts = [int(a[2].max()) for a in inputs]
    meets = [rect_meets(a) for a in inputs]

    fns = {**{label: a.tile for label, a in against.items()},
           "current": tile_kernel.resolve_tiles_cuda}
    turns = in_turns(fns, inputs, reps=20)
    heavy = in_turns(fns, [tile_counts_only(a, True) for a in inputs],
                     reps=20)
    empty = in_turns(fns, [tile_counts_only(a, False) for a in inputs],
                     reps=20)
    times = turn_means(turns["current"])
    heaviest_ms = statistics.mean(heavy["current"]["ms"])
    empty_ms = statistics.mean(empty["current"]["ms"])
    plain_ms = cuda_time_ms(
        lambda: [tile_kernel.resolve_tiles_plain(*a) for a in inputs],
        reps=5) / n_views
    # The bound of the mean view. Operations: 12 at each of a warp's 128
    # pixels for every (candidate, warp) test the kernel's cull leaves, as
    # the kernel counts them in this run. Bytes: the counts, the listed
    # candidate ids, one read of each table row they name, and one write
    # of the (H, W) depth + id images. bound_every_pair_ms keeps the
    # earlier count: every candidate at all 4096 pixels of its tile.
    run, view_bytes = [], []
    for a in inputs:
        table, cand, counts = a[:3]
        tested = torch.zeros(1, dtype=torch.int64, device=device)
        tile_kernel.resolve_tiles_cuda(*a, tested=tested)
        run.append(int(tested))
        slot = torch.arange(cand.shape[1], device=cand.device)
        live = slot < counts[:, None]
        rows = int(torch.unique(cand[live]).numel())
        view_bytes.append(counts.numel() * 4 + int(counts.sum()) * 4
                          + rows * table.shape[1] * 4 + width * height * 8)
    culled = [1 - r / (tile_kernel.WARPS * s) if s else 0.0
              for r, s in zip(run, sum_counts)]
    nbytes = statistics.mean(view_bytes)
    tile_pixels = tile_kernel.TILE_H * tile_kernel.TILE_W
    bound_ms, bound_by, ops_ms, bytes_ms = bound(
        statistics.mean(run) * (tile_pixels // tile_kernel.WARPS)
        * FLOPS_PER_TEST, nbytes)
    mean_counts = statistics.mean(sum_counts)
    every_ms = bound(mean_counts * tile_pixels * FLOPS_PER_TEST, nbytes)[0]
    phase(
        f"phase 5 [{card}]: {name}{' indoor + clip' if clip else ''} "
        f"({n_views} views {width}x{height}), per "
        f"view: raster_tile {times['ms']:.6f} ms (graph replays), "
        f"{times['launched_ms']:.6f} ms launched view by view; turns "
        f"{turns}; heaviest tile alone {heaviest_ms:.6f} ms (turns "
        f"{ {k: v['ms'] for k, v in heavy.items()} }); every tile empty "
        f"{empty_ms:.6f} ms (turns { {k: v['ms'] for k, v in empty.items()} }"
        f"); plain {plain_ms:.6f} ms; bound {bound_ms:.6f} ms ({bound_by}: "
        f"ops {ops_ms:.6f} ms for the (candidate, warp) tests run at "
        f"{PEAK_FP32_OPS / 1e12} T operations/s, bytes {bytes_ms:.6f} ms), "
        f"every candidate at every pixel of its tile {every_ms:.6f} ms; "
        f"culled share of (candidate, warp) tests "
        f"{statistics.mean(culled):.6f} (per view "
        f"{[round(c, 6) for c in culled]}); tests run per view {run}; "
        f"sum(counts) per view {sum_counts} (mean {mean_counts}), heaviest "
        f"tile per view {max_counts}; (candidate, 16x8 rectangle) pairs "
        f"past the edge test alone per view {[m[0] for m in meets]}, most "
        f"in one rectangle per view {[m[1] for m in meets]}"
    )
    return dict(times, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, bound_every_pair_ms=every_ms,
                heaviest_tile_ms=heaviest_ms, empty_ms=empty_ms,
                culled_share=statistics.mean(culled), tests_run=run,
                **against_entry(against,
                                lambda k: turn_means(turns[k]),
                                lambda k: {
                                    "heaviest_tile_ms":
                                        statistics.mean(heavy[k]["ms"]),
                                    "empty_ms":
                                        statistics.mean(empty[k]["ms"])}))


def heaviest_alone(args):
    """resolve_dense arguments of one view with every tile's own range
    emptied except the heaviest tile's (the global bucket kept)."""
    table, sorted_ids, starts, *rest = args
    s = starts.long()
    B = s.numel() - 2
    b = int((s[1:B + 1] - s[:B]).argmax())
    mine = sorted_ids[int(s[b]):int(s[b + 1])]
    ids = torch.cat([mine, sorted_ids[int(s[B]):int(s[B + 1])]])
    t = torch.arange(B + 2, device=s.device)
    new = torch.where(t <= b, 0, mine.numel())
    new[B + 1] = ids.numel()
    return (table, ids.contiguous(), new.to(torch.int32), *rest)


def dense_times(ctx, device, card, against):
    """Per-view pieces of the dense path at `scannet`: setup + classify +
    binning + table, the micro path, raster_dense (dense_kernel_row, and
    its plain version), fusion, and the routing cost model's coefficients
    these times give, each as launched from Python. Returns the kernel's
    row."""
    from semantic_meshes_torch import fusion
    from semantic_meshes_torch import rasterize as rast
    from semantic_meshes_torch.rasterize import (dense, dense_kernel,
                                                 tile_kernel, tiles)

    _, n_views, width, height, classes = SCENES["scannet"]
    vertices, faces, cams, cap = (ctx["vertices"], ctx["faces"], ctx["cams"],
                                  ctx["cap"])
    T = len(faces)
    fv = face_vertices(vertices, faces, device)
    kw = dense.DenseBudget.of(cap).kwargs()
    e_cap = dense._cdiv(max(kw["e_cap_rows"], dense.CHUNK),
                        dense.CHUNK) * dense.CHUNK
    micro_max = kw["micro_max"]
    micro_cap = min(dense._cdiv(max(kw["micro_cap_rows"], 8), 8) * 8, T)

    def setups():
        return [tiles.setup_inputs(None, None, *cam_args(c),
                                   face_vertices=fv, device=device)
                for c in cams]

    def bins(setup_list):
        out = []
        for s in setup_list:
            sorted_ids, starts, _, micro = dense._build_sorted_bins(
                s, height, width, 0.0, e_cap, dense.N_GLOBAL, micro_max)
            out.append((tile_kernel.candidate_table(s), sorted_ids, starts,
                        micro))
        return out

    setup_ms = cuda_time_ms(setups, reps=10) / n_views
    setup_list = setups()
    bin_ms = cuda_time_ms(lambda: bins(setup_list), reps=10) / n_views
    binned = bins(setup_list)
    micro_ms = cuda_time_ms(lambda: [
        dense._micro_key(s, b[3], height, width, 0.0, micro_max=micro_max,
                         micro_cap_rows=kw["micro_cap_rows"])
        for s, b in zip(setup_list, binned)], reps=10) / n_views
    inputs = []
    for s, (table, sorted_ids, starts, micro) in zip(setup_list, binned):
        key, _ = dense._micro_key(s, micro, height, width, 0.0,
                                  micro_max=micro_max,
                                  micro_cap_rows=kw["micro_cap_rows"])
        inputs.append((table, sorted_ids, starts, dense.N_GLOBAL, key, 0.0,
                       dense._cdiv(width, dense.TILE_W), height, width))

    kernel = dense_kernel_row("scannet", inputs, against, card)
    # one run of the 8 views: at ~1-1.5 s a view the plain version is
    # 10^4 times the kernel, and five runs took ~50 s of the script's time
    plain_ms = cuda_time_ms(lambda: [dense_kernel.resolve_dense_plain(*a)
                                     for a in inputs], reps=1,
                            warmup=0) / n_views
    ids = [dense_kernel.resolve_dense_cuda(*a)[1] for a in inputs]
    fusion_ms = cuda_time_ms(
        lambda: [fusion._accumulate_view(ids[k], ctx["probs"][k], None, IEW,
                                         num_primitives=T, aggregator="sum")
                 for k in range(n_views)],
        reps=10) / n_views
    frag_rows = micro_max * micro_max * micro_cap
    pairs = statistics.mean(kernel["pairs"])
    coeffs = dict(alpha=kernel["launched_ms"] * 1e6 / pairs,
                  beta=micro_ms * 1e6 / frag_rows,
                  gamma=bin_ms * 1e6 / (dense.K_SPAN * T))
    phase(
        f"phase 5 [{card}]: scannet ({n_views} views {width}x{height}, {T} "
        f"triangles, budget {cap}), per view: setup {setup_ms:.6f} ms, "
        f"classify + sort binning + table {bin_ms:.6f} ms, micro path "
        f"{micro_ms:.6f} ms ({frag_rows} fragment rows), raster_dense "
        f"{kernel['launched_ms']:.6f} ms launched view by view "
        f"({kernel['ms']:.6f} ms in graph replays), plain {plain_ms:.6f} "
        f"ms, fusion (sum, {classes} classes) {fusion_ms:.6f} ms"
    )
    phase(
        f"phase 5 [{card}]: routing cost model at scannet, ns, each from "
        f"times launched from Python: alpha (raster_dense per pair) "
        f"{coeffs['alpha']:.6f} ({kernel['ms'] * 1e6 / pairs:.6f} from "
        f"graph replays), beta (micro path per fragment row) "
        f"{coeffs['beta']:.6f}, gamma (classify + binning per sort row) "
        f"{coeffs['gamma']:.6f}; in use: alpha {dense.ROUTE_ALPHA}, beta "
        f"{dense.ROUTE_BETA}, gamma {dense.ROUTE_GAMMA}"
    )
    row = {k: v for k, v in kernel.items() if k != "pairs"}
    return dict(row, plain_ms=plain_ms)


def dense_kernel_row(label, inputs, against, card):
    """raster_dense on every view of `inputs` (resolve_dense arguments):
    ms per view, and on each view's heaviest tile alone, in turns with
    each --against copy; the bound of the mean view from this run's
    inputs; work items and the culled share of (candidate, warp) tests per
    view. Prints one line; returns the numbers."""
    from semantic_meshes_torch.rasterize import dense_kernel

    fns = {**{k: a.dense for k, a in against.items()},
           "current": dense_kernel.resolve_dense_cuda}
    turns = in_turns(fns, inputs, reps=20)
    heavy = in_turns(fns, [heaviest_alone(a) for a in inputs], reps=20)

    # The bound of the mean view. Operations: 12 at each of a warp's 256
    # pixels for every (candidate, warp) test the kernel's cull leaves, as
    # the kernel counts them in this run. Bytes: one read of the starts,
    # of the ids read (the global ids once, the own ranges once), of each
    # table row they name and of the micro key image, and one write of
    # the 8-byte-per-pixel image. bound_every_pair_ms keeps the earlier count:
    # every listed pair at all 2048 pixels of its tile at 67 TFLOP/s.
    warp_pixels = dense_kernel.TILE_H * dense_kernel.TILE_W // \
        dense_kernel.WARPS
    tests, run, view_bytes, pairs, items, heaviest = [], [], [], [], [], []
    for args in inputs:
        table, sorted_ids, starts, n_global, key, _, _, height, width = args
        s = starts.long()
        B = s.numel() - 2
        g = max(min(int(s[B + 1] - s[B]), n_global), 0)
        own_b = s[1:B + 1] - s[:B]
        own = int(own_b.sum())
        tests.append(B * g + own)
        pairs.append(int(s[B + 1] - s[0]))
        heaviest.append(int(own_b.max()))
        items.append(int(dense_kernel.work_items(starts, n_global).sum()))
        tested = torch.zeros(1, dtype=torch.int64, device=table.device)
        dense_kernel.resolve_dense_cuda(*args, tested=tested)
        run.append(int(tested))
        rows = torch.cat([sorted_ids[int(s[B]):int(s[B]) + g],
                          sorted_ids[:int(s[B])]])
        view_bytes.append((B + 2) * 4 + (g + own) * 4
                          + int(torch.unique(rows).numel()) * 64
                          + (0 if key is None else key.numel() * 8)
                          + width * height * 8)
    culled = [1 - r / (dense_kernel.WARPS * t) if t else 0.0
              for r, t in zip(run, tests)]
    nbytes = statistics.mean(view_bytes)
    bound_ms, bound_by, ops_ms, bytes_ms = bound(
        statistics.mean(run) * warp_pixels * FLOPS_PER_TEST, nbytes)
    every_ms = bound(statistics.mean(tests) * dense_kernel.TILE_H
                     * dense_kernel.TILE_W * FLOPS_PER_TEST, nbytes,
                     PEAK_FP32_FLOPS)[0]
    out = dict(
        turn_means(turns["current"]), bound_ms=bound_ms, bound_by=bound_by,
        bound_every_pair_ms=every_ms,
        heaviest_tile_ms=statistics.mean(heavy["current"]["ms"]),
        items_per_view=items, culled_share=statistics.mean(culled),
        **against_entry(against, lambda k: turn_means(turns[k]),
                        lambda k: {"heaviest_tile_ms":
                                   statistics.mean(heavy[k]["ms"])}),
        pairs=pairs)
    phase(
        f"phase 5 [{card}]: raster_dense at {label} ({len(inputs)} views), "
        f"per view: {out['ms']:.6f} ms (graph replays), "
        f"{out['launched_ms']:.6f} ms launched view by view; turns {turns}; "
        f"heaviest tile alone {out['heaviest_tile_ms']:.6f} ms (turns "
        f"{ {k: v['ms'] for k, v in heavy.items()} }); bound "
        f"{bound_ms:.6f} ms ({bound_by}: ops {ops_ms:.6f} ms for the "
        f"(candidate, warp) tests run at {PEAK_FP32_OPS / 1e12} T "
        f"operations/s, bytes {bytes_ms:.6f} ms), every pair at every "
        f"pixel at 67 TFLOP/s {every_ms:.6f} ms; culled share of "
        f"(candidate, warp) tests {out['culled_share']:.6f} (per view "
        f"{[round(c, 6) for c in culled]}); tests run per view {run}, "
        f"pairs per view {pairs}, candidate tests per view {tests}, "
        f"heaviest own range per view {heaviest}, work items per view "
        f"{items}"
    )
    return out


def dense_prep_row(ctx, device, card):
    """The dense preparation on every view of `scannet` at its probed
    budget (dense.resolve_inputs on the card: the three dense_prep kernels
    and the sort), per view: ms from CUDA-graph replays, launched_ms as
    launched from Python view by view, the plain chain's time launched
    (plain_ms), and the bound of the bytes it has to move: each face's 36
    bytes read, a 64-byte table row and five 4-byte sorted ids written a
    row (up to the pair budget), the tile starts, and the 8-byte micro key
    a pixel. Prints one line; returns the numbers."""
    from semantic_meshes_torch import rasterize as rast
    from semantic_meshes_torch.rasterize import dense

    vertices, faces, cams, cap = (ctx["vertices"], ctx["faces"], ctx["cams"],
                                  ctx["cap"])
    fv = face_vertices(vertices, faces, device)
    n = len(cams)
    kw = dense.DenseBudget.of(cap).kwargs()

    def prepare():
        return [dense_view_inputs(fv, cam, cap, device) for cam in cams]

    def plain():
        return [dense.resolve_inputs_plain(None, None, *cam_args(cam),
                                           face_vertices=fv, device=device,
                                           **cam_kw(cam), **kw)
                for cam in cams]

    launched_ms = cuda_time_ms(prepare, reps=10) / n
    ms = graph_time_ms(prepare, reps=10) / n
    plain_ms = cuda_time_ms(plain, reps=3) / n
    width, height = cams[0].resolution
    rows = len(faces)
    e_cap = dense._e_cap(rows, 3, kw.get("e_cap_rows"))
    tiles = dense._cdiv(height, dense.TILE_H) * dense._cdiv(width,
                                                            dense.TILE_W)
    nbytes = (rows * 36 + (rows + 1) * 64 + min(e_cap, 5 * rows) * 4
              + (tiles + 2) * 4 + width * height * 8)
    bound_ms = nbytes / PEAK_BYTES_S * 1e3
    phase(
        f"phase 5 [{card}]: dense_prep at scannet ({n} views {width}x"
        f"{height}, {rows} rows, budget {cap}), per view: {ms:.6f} ms "
        f"(graph replays), {launched_ms:.6f} ms launched view by view; the "
        f"plain chain {plain_ms:.6f} ms launched; bytes bound "
        f"{bound_ms:.6f} ms for {nbytes} bytes at {PEAK_BYTES_S / 1e12} "
        "TB/s"
    )
    return dict(ms=ms, launched_ms=launched_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", bytes=nbytes)


# fusion row: the benchmark's configurations whose scenes it renders
# (benchmark/configs/<name>.json; "scannet-room" looks at the floor and
# walls from inside the room, every pixel covered), and views a shape
FUSION_SHAPES = ("scannet-eval", "cityscapes-demo", "scannet-room")
FUSION_VIEWS = 8
FUSION_KERNELS = ("fusion_keys_kernel", "fusion_rows_kernel",
                  "fusion_carry_kernel")
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemset", "cuMemset",
                "cudaMemcpy", "cuMemcpy")


def fusion_traced(fn):
    """(device ms of each fusion kernel (FUSION_KERNELS), of everything,
    launch calls) of fn() under torch.profiler, or None where it saw no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
    except RuntimeError:
        return None
    # outside every try: a failure of fn itself ends the run
    fn()
    torch.cuda.synchronize()
    try:
        prof.stop()
        kernels = device_times(prof)
    except (RuntimeError, AttributeError):
        return None
    if not kernels:
        return None
    ours = [sum(ms for name, (ms, _) in kernels.items() if kernel in name)
            for kernel in FUSION_KERNELS]
    calls = sum(1 for e in prof.profiler.kineto_results.events()
                if "CUDA" not in str(e.device_type())
                and e.name().startswith(LAUNCH_CALLS))
    return ours, sum(ms for ms, _ in kernels.values()), calls


def fusion_row(device, card):
    """Fusion of one view at the benchmark's shapes (FUSION_SHAPES: the
    rendered ids of FUSION_VIEWS views on the configuration's ring around or
    inside its cube, unjittered, random softmax probabilities made on the
    card, the ids' (H, W) view strided as MeshAggregator.add passes it). On every view the kernels
    (fusion_kernel.segment_sums) against the plain chain
    (fusion._segment_sums_plain + _mix) on the same tensors: rows inside
    one chunk of sorted positions bit-equal, the others within rtol 1e-5,
    atol 1e-6; twice, bit-identical. Per view: ms with the sort from CUDA
    graph replays and launched view by view, the kernels' own device ms
    without the sort (torch.profiler), the plain chain's ms launched, the
    launches of each, and the bound of the bytes (the probabilities and
    ids read once, the (P, C) rows written once) at PEAK_BYTES_S. Prints a
    line per shape; returns {shape: numbers}."""
    import semantic_meshes_torch as smt
    from semantic_meshes_torch import fusion, fusion_kernel

    torch.cuda.empty_cache()
    rows = {}
    n = FUSION_VIEWS
    for name in FUSION_SHAPES:
        with open(os.path.join(HERE, "benchmark", "configs",
                               f"{name}.json")) as fh:
            cfg = json.load(fh)
        width, height = cfg["width"], cfg["height"]
        classes, agg, ring = cfg["classes"], cfg["aggregator"], cfg["ring"]
        vertices, faces = smt.testing.make_cube(
            subdivisions=cfg["subdivisions"], size=cfg["mesh_size"])
        cams = smt.testing.make_ring_cameras(
            num_views=n, width=width, height=height, radius=ring["radius"],
            elevation=ring["elevation"],
            focal=cfg["intrinsics"]["focal"][0], target=tuple(ring["target"]))
        renderer = smt.render.triangles(
            SimpleNamespace(vertices=vertices, faces=faces), device=device)
        renderer.prepare(cams)
        prims = [fusion.as_ids(renderer.render(cam)[0], device).t()
                 for cam in cams]
        probs = device_probs(n, height, width, classes, device)
        P = len(faces)
        kw = dict(num_primitives=P, aggregator=agg)

        def kernels():
            return [fusion_kernel.segment_sums(prims[k], probs[k], None, IEW,
                                               **kw) for k in range(n)]

        def plain():
            return [fusion._mix(fusion._segment_sums_plain(
                prims[k], probs[k], None, **kw), IEW) for k in range(n)]

        fusion_kernel.launches = 0
        got, again, want = kernels(), kernels(), plain()
        if fusion_kernel.launches != 6 * n:
            raise AssertionError(f"fusion at {name}: {fusion_kernel.launches}"
                                 f" kernel launches for 2 x {n} views")
        straddling, err = 0, 0.0
        for k in range(n):
            if not torch.equal(got[k].view(torch.int32),
                               again[k].view(torch.int32)):
                raise AssertionError(f"fusion at {name} view {k}: repeated "
                                     "fusion is not bit-identical")
            exact = smt.testing.inside_one_chunk(prims[k], P)
            if not torch.equal(got[k][exact].view(torch.int32),
                               want[k][exact].view(torch.int32)):
                bad = int((got[k][exact] != want[k][exact]).any(1).sum())
                raise AssertionError(f"fusion at {name} view {k}: {bad} rows "
                                     "inside one chunk != the plain chain")
            if not torch.allclose(got[k], want[k], rtol=1e-5, atol=1e-6):
                raise AssertionError(f"fusion at {name} view {k}: rows "
                                     "across chunks past rtol 1e-5")
            straddling += int((~exact).sum())
            err = max(err, float((got[k] - want[k]).abs().max()))
        del got, again, want
        ms = graph_time_ms(kernels, reps=10) / n
        launched_ms = cuda_time_ms(kernels, reps=10) / n
        plain_ms = cuda_time_ms(plain, reps=3) / n
        traced = fusion_traced(kernels)
        traced_plain = fusion_traced(plain)
        nbytes = width * height * (classes + 1) * 4 + P * classes * 4
        bound_ms = nbytes / PEAK_BYTES_S * 1e3
        row = dict(ms=ms, launched_ms=launched_ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by="bytes", bytes=nbytes,
                   max_abs_err=err, rows_across_chunks=straddling / n)
        if traced is None or traced_plain is None:
            kernel_ms = "not measured (the profiler saw no device time)"
        else:
            row.update(kernel_ms=sum(traced[0]) / n,
                       kernel_ms_each=dict(zip(
                           FUSION_KERNELS, (ms / n for ms in traced[0]))),
                       device_ms=traced[1] / n,
                       launch_calls=traced[2] / n,
                       plain_device_ms=traced_plain[1] / n,
                       plain_launch_calls=traced_plain[2] / n)
            kernel_ms = (
                f"{row['kernel_ms']:.6f} ms the three kernels' device time "
                "without the sort ("
                + ", ".join(f"{k} {v:.6f}"
                            for k, v in row["kernel_ms_each"].items())
                + f"), {row['device_ms']:.6f} ms with it "
                f"({row['launch_calls']:.2f} launch calls; the plain chain "
                f"{row['plain_device_ms']:.6f} ms, "
                f"{row['plain_launch_calls']:.2f} launch calls)")
        phase(
            f"phase 5 [{card}]: fusion at {name} ({n} views {width}x{height}"
            f", {classes} classes, {agg}, {P} primitives), per view: "
            f"{ms:.6f} ms (graph replays), {launched_ms:.6f} ms launched "
            f"view by view, {kernel_ms}; the plain chain {plain_ms:.6f} ms "
            f"launched; bytes bound {bound_ms:.6f} ms for {nbytes} bytes at "
            f"{PEAK_BYTES_S / 1e12} TB/s; == plain chain on all {n} views "
            f"({straddling / n:.1f} rows a view across chunks, max |err| "
            f"{err:.3e}), repeated bit-identical"
        )
        rows[name] = row
    return rows


def device_busy(label, entry, fn, batch_ms, card, tag="phase 5"):
    """One traced batch: the device's busy time (sum of the kernels' own
    device times, from torch.profiler), its share of the untraced batch
    time, and the kernels that take the most. Diagnostic only: a profiler
    that sees no device time reports "not measured". The trace records
    device activity alone: host ops would add an event to each of a
    distorted batch's ~10^5 launches, and the busy time reads none. tag:
    the phase that prints the line."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    except RuntimeError as e:
        prof, why = None, e
    # outside every try: a failure of the batch itself ends the run
    fn()
    torch.cuda.synchronize()
    if prof is None:
        phase(f"{tag} [{card}]: {label} device busy share: not measured "
              f"({why})")
        return
    try:
        prof.stop()
        kernels = device_times(prof)
    except (RuntimeError, AttributeError) as e:
        phase(f"{tag} [{card}]: {label} device busy share: not measured "
              f"({e})")
        return
    if not kernels:
        phase(f"{tag} [{card}]: {label} device busy share: not measured "
              "(the profiler saw no device time)")
        return
    busy_ms = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    phase(
        f"{tag} [{card}]: {label}, one traced {entry} batch: "
        f"device busy {busy_ms:.6f} ms of the untraced {batch_ms:.6f} ms "
        f"(idle share {1 - busy_ms / batch_ms:.6f}); top device time: "
        + "; ".join(f"{name[:60]} {ms:.6f} ms x{n}"
                    for name, (ms, n) in top)
    )


def device_times(prof):
    """{name: [device ms, count]} of the kernels and copies of a stopped
    trace, summed from its raw events (key_averages() would first build
    an event per host op, about a minute for a distorted batch's ~10^5
    launches)."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if "CUDA" in str(e.device_type()):
            entry = out.setdefault(e.name(), [0.0, 0])
            entry[0] += e.duration_ns() / 1e6
            entry[1] += 1
    return out


def batch_throughput(name, ctx, device, card, label=None):
    """rasterize_fuse_throughput of one batch at preset `name`
    (fuse_views_planned, or ctx's own "batch" and "entry": a texel
    preset's fuse_views_texels, a distorted variant's fusion), and one
    traced batch; returns the batch's ms. label: the variant's name
    (default `name`). The batch's
    time is the median of 5 after 2 warm-ups, or ctx's "batch_ms" where
    phase 4 timed a batch whose extended lenses make every run cost
    seconds."""
    import semantic_meshes_torch as smt

    _, n_views, width, height, classes = SCENES[name]
    label = label or name
    T = len(ctx["faces"])
    P = ctx.get("primitives", T)
    entry = ctx.get("entry", "fuse_views_texels" if "batch" in ctx
                    else "fuse_views_planned")

    def planned_batch():
        return smt.distributed.fuse_views_planned(
            ctx["plan"], ctx["vertices"], ctx["rot"], ctx["trans"],
            ctx["fl"], ctx["pp"], ctx["probs"], IEW, num_primitives=T,
            aggregator="sum", height=height, width=width, device=device)

    fused_batch = ctx.get("batch", planned_batch)
    batch_ms = ctx.get("batch_ms") or cuda_time_ms(fused_batch, reps=5)
    mpix_s = n_views * width * height / 1e6 / (batch_ms / 1e3)
    phase(f"phase 5 [{card}]: {label}, {entry} batch {batch_ms:.6f} ms for "
          f"{n_views} views")
    device_busy(label, entry, fused_batch, batch_ms, card)
    plan = ctx.get("plan")
    budget = None if plan is None or plan.dense_e_cap is None else \
        dataclasses.asdict(plan.dense_e_cap)
    print(json.dumps({
        "metric": "rasterize_fuse_throughput", "value": mpix_s,
        "unit": "MPix/s", "card": card,
        "detail": {"preset": name, "variant": label, "views": n_views,
                   "resolution": [width, height], "triangles": T,
                   "primitives": P, "classes": classes,
                   "batch_ms": batch_ms, "entry": entry,
                   "dense_e_cap": budget},
    }), flush=True)
    return batch_ms


def batches_in_turns(label_a, fn_a, label_b, fn_b, card):
    """Device-event times of two batches on the same scene in turns (a, b,
    b, a in each round, after one warm-up each), so the host's load
    reaches both alike: each one's median and spread, the ratio of the
    medians and the share of rounds b won."""
    rounds = 5
    fn_a(), fn_b()
    times = {label_a: [], label_b: []}
    for _ in range(rounds):
        for label, fn in ((label_a, fn_a), (label_b, fn_b), (label_b, fn_b),
                          (label_a, fn_a)):
            times[label].append(cuda_time_ms(fn, reps=1, warmup=0))
    a, b = times[label_a], times[label_b]
    wins = sum(b[2 * k] + b[2 * k + 1] < a[2 * k] + a[2 * k + 1]
               for k in range(rounds))
    med_a, med_b = statistics.median(a), statistics.median(b)
    phase(
        f"phase 5 [{card}]: in turns ({rounds} rounds of a b b a), batch ms: "
        f"a = {label_a} median {med_a:.6f} (min {min(a):.6f}, max "
        f"{max(a):.6f}), b = {label_b} median {med_b:.6f} (min {min(b):.6f}, "
        f"max {max(b):.6f}); throughput b / a {med_a / med_b:.6f}; b faster "
        f"in {wins} of {rounds} rounds"
    )


def large_times(ctx, device, card):
    """Setup + binning and fusion per view at `large` (tile rasterizer)."""
    from semantic_meshes_torch import fusion
    from semantic_meshes_torch.rasterize import tile_kernel

    _, n_views, width, height, classes = SCENES["large"]
    cams, probs = ctx["cams"], ctx["probs"]
    T = len(ctx["faces"])
    fv = face_vertices(ctx["vertices"], ctx["faces"], device)
    setup_ms = cuda_time_ms(
        lambda: [view_inputs(fv, cam, device) for cam in cams],
        reps=10) / n_views
    ids = [tile_kernel.resolve_tiles_cuda(*view_inputs(fv, cam, device)[0])[1]
           for cam in cams]
    fusion_ms = cuda_time_ms(
        lambda: [fusion._accumulate_view(ids[k], probs[k], None, IEW,
                                         num_primitives=T, aggregator="sum")
                 for k in range(n_views)],
        reps=10) / n_views
    phase(f"phase 5 [{card}]: large, per view: setup+binning "
          f"{setup_ms:.6f} ms, fusion (sum) {fusion_ms:.6f} ms")


def texel_times(name, ctx, device, card):
    """Per view at a texel preset, each as launched from Python (CUDA
    events, medians): setup + dense binning (setup, classify, sort
    binning, the micro path and the table: dense.resolve_inputs),
    raster_dense, the texel shader's kernels (also from graph replays,
    with the bound of its bytes, and the plain chain it replaces, whose
    ids they equal on every view) and fusion (sum over the texels)."""
    from semantic_meshes_torch import fusion, render
    from semantic_meshes_torch.rasterize import dense_kernel

    _, n_views, width, height, classes = SCENES[name]
    renderer, cams, cap = ctx["renderer"], ctx["cams"], ctx["cap"]
    P = renderer.getPrimitivesNum()
    fv = renderer.face_vertices
    setup_ms = cuda_time_ms(
        lambda: [dense_view_inputs(fv, cam, cap, device) for cam in cams],
        reps=5) / n_views
    inputs = [dense_view_inputs(fv, cam, cap, device)[0] for cam in cams]
    kernel_ms = cuda_time_ms(
        lambda: [dense_kernel.resolve_dense_cuda(*a) for a in inputs],
        reps=10) / n_views
    tris = [dense_kernel.resolve_dense_cuda(*a)[1] for a in inputs]
    # camera arrays on the card, as a batch's slices reach the shader
    cam_t = [tuple(torch.as_tensor(a, device=device) for a in cam_args(c))
             for c in cams]

    def shade_all(shader=render._texel_prim_image):
        return [shader(
            renderer.vertices, renderer.faces, *ca, tri, renderer.resolutions,
            renderer.first_texel_index, P) for ca, tri in zip(cam_t, tris)]

    shader_ms = cuda_time_ms(shade_all, reps=10) / n_views
    shader_graph_ms = graph_time_ms(shade_all, reps=10) / n_views
    shader_plain_ms = cuda_time_ms(
        lambda: shade_all(render._texel_prim_image_plain), reps=3) / n_views
    prims = shade_all()
    for k, plain in enumerate(shade_all(render._texel_prim_image_plain)):
        if not torch.equal(prims[k], plain):
            raise AssertionError(f"{name} view {k}: the texel kernels differ "
                                 "from the plain chain on "
                                 f"{int((prims[k] != plain).sum())} pixels")
    fusion_ms = cuda_time_ms(
        lambda: [fusion._accumulate_view(prims[k], ctx["probs"][k], None, IEW,
                                         num_primitives=P, aggregator="sum")
                 for k in range(n_views)], reps=5) / n_views
    # the shader's least bytes: each input read once (the triangle-id
    # image, the vertices, the int64 faces, the resolutions and first
    # texel indices) and the texel-id image written once
    nbytes = (width * height * 8 + renderer.vertices.numel() * 4
              + renderer.faces.numel() * 8 + len(renderer.faces) * 8)
    shader_bound = nbytes / PEAK_BYTES_S * 1e3
    phase(
        f"phase 5 [{card}]: {name} ({n_views} views {width}x{height}, "
        f"{len(renderer.faces)} triangles, {P} texels, budget {cap}), per "
        f"view: setup + dense binning + micro path + table {setup_ms:.6f} "
        f"ms, raster_dense {kernel_ms:.6f} ms, texel shader {shader_ms:.6f} "
        f"ms launched ({shader_graph_ms:.6f} ms in graph replays; its bytes "
        f"bound {shader_bound:.6f} ms for {nbytes} bytes; the plain chain "
        f"{shader_plain_ms:.6f} ms launched, == the kernels on every view), "
        f"fusion (sum, "
        f"{classes} classes over {P} texels) "
        f"{fusion_ms:.6f} ms"
    )
    return dict(setup_ms=setup_ms, kernel_ms=kernel_ms, shader_ms=shader_ms,
                shader_graph_ms=shader_graph_ms, shader_bound_ms=shader_bound,
                shader_plain_ms=shader_plain_ms,
                fusion_ms=fusion_ms)


# the ScanNet eval path (phase 6): eval_scannet.py around the renderer,
# with the model left out, at `scannet` and ScanNet's own sizes: a stream
# of EVAL_FRAMES frames (a scene holds 10^3-10^4; the eval samples every
# EVAL_STEP-th), 640x480 depth in mm (depth_shift 1000), colour blobs of
# a JPEG's size, NYU40 classes, top-K = EVAL_TOPK probability files
EVAL_FRAMES = 1024
EVAL_STEP = 128
EVAL_DEPTH_HW = (480, 640)
EVAL_COLOR_BYTES = 150_000
EVAL_TOPK = 3
# views whose network labels are partly flipped (EVAL_FLIP of the faces
# carry another class), so the fused labels can beat the network's
EVAL_FLIPPED = (1, 5)
EVAL_FLIP = 0.3
EVAL_WIRES = ("f32", "f16", "u8")
# the phases of one traced pass of eval_scannet.py's frame loop
EVAL_PASS = ("render", "load", "predict", "metrics_network", "fuse")


def intrinsic_matrix(fl, pp, scale=1.0):
    k = np.eye(4, dtype=np.float32)
    k[0, 0], k[1, 1] = fl[0] * scale, fl[1] * scale
    k[0, 2], k[1, 2] = pp[0] * scale, pp[1] * scale
    return k


def write_eval_stream(path, cams, depth_mm, rng):
    """write_sens of EVAL_FRAMES frames: the sorted stream dwells
    EVAL_FRAMES / views frames on each view in turn (frames[::EVAL_STEP]
    then holds one frame a view, in view order), written in the order of
    a seeded permutation of the timestamps. A view's depth blob is zlib of
    its rendered depth in mm, reused; every colour blob is random bytes.
    Returns the bytes written."""
    from semantic_meshes_torch.data2.scannet import write_sens

    width, height = cams[0].resolution
    world_to_cam = []
    for cam in cams:
        m = np.eye(4)
        m[:3, :3], m[:3, 3] = cam.rotation, cam.translation
        world_to_cam.append(m)
    camera_to_world = [np.linalg.inv(m).astype(np.float32)
                       for m in world_to_cam]
    blobs = [zlib.compress(d.tobytes()) for d in depth_mm]
    per_view = EVAL_FRAMES // len(cams)
    stamps = rng.permutation(EVAL_FRAMES)
    frames = [dict(camera_to_world=camera_to_world[int(ts) // per_view],
                   timestamp_color=int(ts), timestamp_depth=int(ts),
                   color_data=rng.bytes(EVAL_COLOR_BYTES),
                   depth_data=blobs[int(ts) // per_view])
              for ts in stamps]
    eye = np.eye(4, dtype=np.float32)
    scale = EVAL_DEPTH_HW[1] / width
    write_sens(path, "chip_smoke", intrinsic_matrix(
        cams[0].focal_lengths, cams[0].principal_point), eye,
        intrinsic_matrix(cams[0].focal_lengths, cams[0].principal_point,
                         scale), eye, (height, width), EVAL_DEPTH_HW,
        1000.0, frames)
    return os.path.getsize(path)


def same_stream(a, b):
    """Headers, frame order, poses, timestamps and payloads equal."""
    for k in ("sensor_name", "color_compression_type",
              "depth_compression_type", "color_width", "color_height",
              "depth_width", "depth_height", "depth_shift"):
        if getattr(a, k) != getattr(b, k):
            raise AssertionError(f".sens readers differ on {k}")
    for k in ("intrinsic_color", "extrinsic_color", "intrinsic_depth",
              "extrinsic_depth"):
        if not np.array_equal(getattr(a, k), getattr(b, k)):
            raise AssertionError(f".sens readers differ on {k}")
    if len(a.frames) != len(b.frames):
        raise AssertionError(".sens readers differ on the frame count")
    for i, (fa, fb) in enumerate(zip(a.frames, b.frames)):
        if (fa.timestamp_color, fa.timestamp_depth) != (
                fb.timestamp_color, fb.timestamp_depth) or not \
                np.array_equal(fa.camera_to_world, fb.camera_to_world) or \
                fa.color_data != fb.color_data or \
                fa.depth_data != fb.depth_data:
            raise AssertionError(f".sens readers differ on frame {i}")


def frame_cameras(sens, frames):
    """eval_scannet.py:379-398: the colour camera's sanity checks, then a
    Camera of each frame (R, t from the inverse of its camera_to_world)."""
    import semantic_meshes_torch as smt

    if not np.all(np.isclose(sens.extrinsic_color, np.eye(4))):
        raise AssertionError(f"colour extrinsics {sens.extrinsic_color}")
    k = np.asarray(sens.intrinsic_color)
    chk = k.copy()
    chk[0, 0] = chk[1, 1] = 1
    chk[0, 2] = chk[1, 2] = 0
    if not np.all(np.isclose(chk, np.eye(4))):
        raise AssertionError(f"colour intrinsics {k}")
    out = []
    for frame in frames:
        w2c = np.linalg.inv(frame.camera_to_world)
        out.append(smt.data.Camera(
            w2c[:3, :3], w2c[:3, 3], (sens.color_width, sens.color_height),
            (k[0, 0], k[1, 1]), (k[0, 2], k[1, 2])))
    return out


def network_probs(peak, classes, gen):
    """(H, W, C) softmax probabilities from seeded noise, peaked at class
    `peak` (H, W) of each pixel."""
    noise = torch.randn(peak.shape + (classes,), generator=gen,
                        device=peak.device)
    noise.scatter_add_(-1, peak[..., None], torch.full(
        peak.shape + (1,), 4.0, device=peak.device))
    return torch.softmax(noise, dim=-1)


def topk_npz(path, probs, k):
    """scripts/precompute_probs.py --topk's layout: u8 values descending,
    uint8 indices, classes."""
    import semantic_meshes_torch as smt

    vals, idx = torch.topk(probs, k, dim=-1)
    np.savez(path, values=smt.probs_io.quantize_u8(vals.cpu().numpy()),
             indices=idx.to(torch.uint8).cpu().numpy(),
             classes=np.int32(probs.shape[-1]))


def timed_load(base, wire, device):
    """probs_io.load(base, wire) step by step with host clocks: (loaded,
    {read, pin, upload ms}, bytes on the wire). The upload is waited for."""
    import semantic_meshes_torch as smt

    t0 = time.perf_counter()
    if wire == "topk":
        with np.load(base + ".npz") as z:
            host = [torch.from_numpy(np.ascontiguousarray(z[key]))
                    for key in ("values", "indices")]
            classes = int(z["classes"])
    else:
        host = [smt.probs_io._cast_wire(np.load(base + ".npy"), wire)]
    t1 = time.perf_counter()
    pinned = [h.pin_memory() for h in host]
    t2 = time.perf_counter()
    dev = [p.to(device, non_blocking=True) for p in pinned]
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    loaded = smt.probs_io.TopKProbs(*dev, classes) if wire == "topk" \
        else dev[0]
    ms = {"read": (t1 - t0) * 1e3, "pin": (t2 - t1) * 1e3,
          "upload": (t3 - t2) * 1e3}
    return loaded, ms, sum(h.nbytes for h in host)


def cm_equal(label, card_group, cpu_cm):
    """Each metric's confusion matrix on the card equals the CPU's bit for
    bit (one CPU ConfusionMatrix fed the same frames); its result equals,
    at rtol 1e-6 (class reductions), the same metric's on the CPU matrix."""
    for m in card_group:
        if not torch.equal(m.full_matrix.cpu(), cpu_cm.full_matrix):
            raise AssertionError(f"{label} {m.name}: the card's confusion "
                                 "matrix differs from the CPU's")
        on_cpu = type(m)(m.classes_num, "error" if m.pred_error
                         else "forbidden", device="cpu")
        on_cpu.merge(cpu_cm)
        if not torch.allclose(m.result().cpu(), on_cpu.result(), rtol=1e-6,
                              atol=0):
            raise AssertionError(f"{label} {m.name}: results differ")


def trace_annotations(trace_file):
    """Names of the user annotations in a Chrome trace."""
    with open(trace_file) as f:
        events = json.load(f).get("traceEvents", [])
    return {e.get("name") for e in events
            if e.get("cat") == "user_annotation"}


def scannet_eval(device, card):
    """Phase 6: eval_scannet.py's path around the renderer at `scannet`,
    the launch counters read around it. Every step is a PhaseTimers
    phase. Returns the launches of raster_dense and of the fusion
    kernels."""
    import semantic_meshes_torch as smt
    from semantic_meshes_torch import native
    from semantic_meshes_torch.data2 import SensFile

    _, n_views, width, height, classes = SCENES["scannet"]
    vertices, faces, cams = scene("scannet")
    T = len(faces)
    timers = smt.profiling.PhaseTimers()
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=device).manual_seed(SEED)
    reset_launches()
    renders = 0
    workdir = tempfile.mkdtemp(prefix="scannet_eval_")
    try:
        renderer = smt.render.triangles(
            SimpleNamespace(vertices=vertices, faces=faces), device=device)
        renderer.prepare(cams)
        cap = renderer.dense_cap_policy._cap[(height, width)]

        # 1. the stream: depth in mm from the port's render of each view
        with timers.phase("write_stream"):
            depth_mm = []
            for cam in cams:
                depth = renderer.render(cam)[1].t()
                renders += 1
                mm = torch.where(torch.isfinite(depth), depth * 1000.0,
                                 torch.zeros_like(depth))
                mm = torch.clamp(torch.round(mm), 0, 65535).to(torch.int32)
                depth_mm.append(smt.data2.scannet._resize_nearest(
                    mm.cpu().numpy().astype("<u2"), EVAL_DEPTH_HW))
            sens_path = os.path.join(workdir, "scene.sens")
            sens_bytes = write_eval_stream(sens_path, cams, depth_mm, rng)

        # 2. read it through the native and the plain reader
        t0 = time.perf_counter()
        native.load()  # builds the host library: not part of a read
        build_s = time.perf_counter() - t0
        reads = {}
        for name, read in (("native", SensFile), ("python", SensFile.plain)):
            with timers.phase(f"read_{name}"):
                t0 = time.perf_counter()
                stream = read(sens_path)
                t1 = time.perf_counter()
                depths = stream.decode_all_depths()
                t2 = time.perf_counter()
            reads[name] = (stream, depths)
            phase(f"phase 6 [{card}]: .sens {name} reader, {EVAL_FRAMES} "
                  f"frames, {sens_bytes} bytes: index {(t1 - t0) * 1e3:.3f} "
                  f"ms, decode_all_depths {(t2 - t1) * 1e3:.3f} ms "
                  f"({depths.nbytes / 1e6 / (t2 - t1):.1f} MB/s inflated)"
                  + (f"; host library built in {build_s:.1f} s"
                     if name == "native" else ""))
        sens, depths = reads["native"]
        same_stream(sens, reads["python"][0])
        if not np.array_equal(depths, reads["python"][1]):
            raise AssertionError("native and python depth batches differ")
        per_view = EVAL_FRAMES // n_views
        for j in range(EVAL_FRAMES):
            if not np.array_equal(depths[j], depth_mm[j // per_view]):
                raise AssertionError(f"decoded depth of frame {j} differs "
                                     "from the one written")
        del reads, depths

        # 3. cameras of frames[::EVAL_STEP], as the eval samples them
        with timers.phase("cameras"):
            eval_cams = frame_cameras(sens, sens.frames[::EVAL_STEP])
        for j, (got, want) in enumerate(zip(eval_cams, cams)):
            err = max(np.abs(got.rotation - want.rotation).max(),
                      np.abs(got.translation - want.translation).max())
            if err > 1e-5 or got.resolution != want.resolution:
                raise AssertionError(f"frame camera {j}: |R, t err| {err}")

        # 4. labels and network probabilities on disk
        with timers.phase("labels_probs"):
            face_labels = torch.from_numpy(
                rng.integers(0, classes, T).astype(np.int64)).to(device)
            other = (face_labels + torch.from_numpy(rng.integers(
                1, classes, T)).to(device)) % classes
            flipped = torch.where(
                torch.from_numpy(rng.random(T) < EVAL_FLIP).to(device),
                other, face_labels)
            ids_wh, gts = [], []
            for j, cam in enumerate(eval_cams):
                ids = renderer.render(cam)[0]
                renders += 1
                ids_wh.append(ids)
                prim = ids.view(torch.int32).t().long()
                hit = prim >= 0
                face = prim.clamp(min=0)
                gt = torch.where(hit, face_labels[face], -1)
                gts.append(gt.to(torch.int32))
                net = flipped if j in EVAL_FLIPPED else face_labels
                peak = torch.where(hit, net[face], torch.randint(
                    0, classes, gt.shape, generator=gen, device=device))
                probs = network_probs(peak, classes, gen)
                np.save(os.path.join(workdir, f"probs{j}.npy"),
                        probs.cpu().numpy())
                topk_npz(os.path.join(workdir, f"topk{j}.npz"), probs,
                         EVAL_TOPK)
                del probs
        if renderer.overflow_total() != 0:
            raise AssertionError("scannet eval renders overflowed")

        # 5. load every wire, densify, fuse the top-k one
        with timers.phase("load_wires"):
            wire_ms, topk = {}, []
            for wire in EVAL_WIRES + ("topk",):
                rows = []
                for j in range(n_views):
                    base = os.path.join(
                        workdir, f"topk{j}" if wire == "topk"
                        else f"probs{j}")
                    loaded, ms, nbytes = timed_load(base, wire, device)
                    t0 = time.perf_counter()
                    dense = smt.probs_io.densify(loaded)
                    torch.cuda.synchronize()
                    ms["densify"] = (time.perf_counter() - t0) * 1e3
                    if dense.shape != (height, width, classes) or \
                            dense.dtype != torch.float32:
                        raise AssertionError(f"{wire}: densify gave "
                                             f"{dense.dtype} {dense.shape}")
                    rows.append(ms)
                    if wire == "topk":
                        topk.append(loaded)
                    del dense
                wire_ms[wire] = ({k: statistics.median(r[k] for r in rows)
                                  for k in rows[0]}, nbytes)
            again = smt.probs_io.load(os.path.join(workdir, "topk0"),
                                      device=device)
            if not (torch.equal(again.values, topk[0].values)
                    and torch.equal(again.indices, topk[0].indices)):
                raise AssertionError("probs_io.load != its timed steps")
        for wire, (ms, nbytes) in wire_ms.items():
            phase(f"phase 6 [{card}]: wire {wire}: {nbytes} bytes a view; "
                  "per view (medians of 8) " + ", ".join(
                      f"{k} {v:.3f} ms" for k, v in ms.items()))

        rot, trans, fl, pp = smt.data.stack_cameras(eval_cams)
        with timers.phase("fuse_batch"):
            values = torch.stack([t.values for t in topk])
            indices = torch.stack([t.indices for t in topk])
            acc, ov = smt.distributed.fuse_views(
                vertices, faces, rot, trans, fl, pp, (values, indices), IEW,
                num_primitives=T, aggregator="sum", height=height,
                width=width, dense_e_cap=cap,
                predict_fn=smt.probs_io.TopKDensify(classes), device=device)
            renders += n_views
            agg = smt.fusion.MeshAggregator(T, classes, "sum", IEW,
                                            device=device)
            for ids, t in zip(ids_wh, topk):
                agg.add(ids, smt.probs_io.densify(t).transpose(0, 1))
            torch.cuda.synchronize()
        if int(ov) != 0:
            raise AssertionError(f"top-k fuse_views overflow {int(ov)}")
        if not torch.equal(acc, agg.state):
            err = float((acc - agg.state).abs().max())
            raise AssertionError(f"top-k fuse_views != per-view render -> "
                                 f"densify -> add (max |err| {err})")
        for j, t in enumerate(topk):
            cpu = smt.probs_io.densify(smt.probs_io.TopKProbs(
                t.values.cpu(), t.indices.cpu(), classes))
            if not torch.equal(smt.probs_io.densify(t).cpu(), cpu):
                raise AssertionError(f"densify view {j}: card != CPU")

        # 6. checkpoint views 0-3, resume, fuse views 4-7
        half = n_views // 2
        with timers.phase("checkpoint"):
            part = smt.fusion.MeshAggregator(T, classes, "sum", IEW,
                                             device=device)
            for ids, t in zip(ids_wh[:half], topk[:half]):
                part.add(ids, smt.probs_io.densify(t).transpose(0, 1))
            ckpt = os.path.join(workdir, "aggregator.npz")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            smt.checkpoint.save_aggregator(ckpt, part, views_done=half)
            t1 = time.perf_counter()
            resumed, done, _ = smt.checkpoint.load_aggregator(ckpt, device)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            for ids, t in zip(ids_wh[done:], topk[done:]):
                resumed.add(ids, smt.probs_io.densify(t).transpose(0, 1))
        if done != half or not torch.equal(resumed.state, agg.state):
            raise AssertionError("resumed fusion != the straight one")
        phase(f"phase 6 [{card}]: checkpoint of the {T}x{classes} f32 state "
              f"({agg.state.nbytes} bytes, file {os.path.getsize(ckpt)}): "
              f"save {(t1 - t0) * 1e3:.3f} ms, load {(t2 - t1) * 1e3:.3f} "
              f"ms; resumed == straight bit for bit")

        # 7. metrics (eval_scannet.py:279-289), on the card and the CPU
        modes = {"network": "forbidden", "fused": "error"}
        with timers.phase("metrics"):
            groups = {label: [cls(classes, mode, device=device) for cls in (
                smt.metrics.Accuracy, smt.metrics.MeanIoU,
                smt.metrics.ConfusionMatrix)]
                for label, mode in modes.items()}
            cpu = {label: smt.metrics.ConfusionMatrix(classes, mode,
                                                      device="cpu")
                   for label, mode in modes.items()}
            model_renderer = agg.renderer()
            for ids, gt, t in zip(ids_wh, gts, topk):
                preds = {"network": smt.probs_io.densify(t),
                         "fused": model_renderer.render(
                             ids, background=0.0).transpose(0, 1)}
                for label, pred in preds.items():
                    for m in groups[label]:
                        m.update_state_labels(gt, pred)
                    cpu[label].update_state_labels(gt.cpu(), pred.cpu())
            torch.cuda.synchronize()
        for label in modes:
            cm_equal(label, groups[label], cpu[label])
            acc_, miou = (float(m.result()) for m in groups[label][:2])
            phase(f"phase 6 [{card}]: {label} metrics: accuracy {acc_:.6f}, "
                  f"mIoU {miou:.6f} (card == CPU confusion matrix)")

        # 8. one traced pass of the frame loop, a user annotation a phase
        trace_dir = os.path.join(workdir, "trace")
        with smt.profiling.trace_to(trace_dir, device=device):
            with timers.phase("render"):
                ids = renderer.render(eval_cams[0])[0]
                renders += 1
            with timers.phase("load"):
                t = smt.probs_io.load(os.path.join(workdir, "topk0"),
                                      device=device)
            with timers.phase("predict"):
                net = smt.probs_io.densify(t)
            with timers.phase("metrics_network"):
                groups["network"][2].update_state_labels(gts[0], net)
            with timers.phase("fuse"):
                agg.add(ids, net.transpose(0, 1))
        found = trace_annotations(os.path.join(
            trace_dir, smt.profiling.TRACE_FILE))
        missing = set(EVAL_PASS) - found
        if missing:
            raise AssertionError(f"trace lacks annotations {missing}")
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    launches = read_launches()
    fused = read_fusion()
    expect = renders if cap.pairs > 0 else 0
    if launches["raster_dense"] != expect or launches["raster_tile"] != 0:
        raise AssertionError(f"scannet eval: launches {launches} for "
                             f"{expect} views rasterized with pairs")
    if fused["views"] == 0:
        raise AssertionError("scannet eval: no view fused by the fusion "
                             "kernels")
    phase(f"phase 6 [{card}]: ScanNet eval path ok at scannet ({n_views} "
          f"views {width}x{height}, {T} triangles, {classes} classes, "
          f"dense budget {cap}): {EVAL_FRAMES}-frame .sens native == "
          "python, frame cameras within 1e-5, top-k fuse_views == "
          "per-view bit for bit, densify card == CPU, resume == straight, "
          f"confusion matrices card == CPU, trace holds {list(EVAL_PASS)}; "
          f"launches {launches}, fusion {fused}; phase timers "
          f"{json.dumps(timers.as_dict())}")
    return launches["raster_dense"], fused["launches"]


# ---------------------------------------------------------------- phase 7
# Multi-GPU fusion: semantic_meshes_torch.distributed.make_sharded_fuse.
# On one card the kernels run on row bands and face blocks, and the fuse
# runs in an NCCL world of one; with two or more cards one NCCL rank per
# card runs every layout of sharded_cases against fuse_views on one card.

BANDS = (2, 4)  # row bands (the `pixels` axis) and face blocks
NO_ID = 2**31 - 1  # the face merge's sentinel, as distributed._NO_ID
# NVLink of one H100 SXM each way (NVIDIA data sheet), used where
# nvidia-smi does not list the links
NVLINK_BYTES_S = 450e9
SHARDED_RTOL, SHARDED_ATOL = 2e-5, 1e-5
RANK_DEADLINE_S = 900


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def band_check(label, vertices, faces, cams, device, plain_views):
    """Every view of a scene in 2 and 4 row bands, each rasterized alone
    at y_offset = row0 with its own height, as a rank of a `pixels` axis
    does: ids and depth bits equal the full render's rows, overflow 0, and
    on `plain_views` the kernel equals its plain version on the band.
    Returns the largest |depth error| against plain (0 when bit-equal)."""
    from semantic_meshes_torch import rasterize as rast
    from semantic_meshes_torch.rasterize import dense, dense_kernel, \
        tile_kernel

    width, height = cams[0].resolution
    fv = face_vertices(vertices, faces, device)
    use_dense = rast.uses_dense(None, len(faces))
    cap = dense_budget(vertices, faces, cams, device) if use_dense else None
    err = 0.0
    for k, cam in enumerate(cams):
        ids, z, ov = rast.rasterize(vertices, faces, *cam_args(cam),
                                    face_vertices=fv, height=height,
                                    width=width, dense_e_cap=cap,
                                    device=device)
        if int(ov):
            raise AssertionError(f"{label} view {k}: overflow {int(ov)}")
        for n in BANDS:
            band = height // n
            for b in range(n):
                row0 = b * band
                kw = dict(face_vertices=fv, height=band, width=width,
                          device=device)
                if use_dense and k in plain_views:
                    args, pargs, ov = dense_view_pair(
                        f"{label} band {b} of {n}", k, fv, cam, cap, device,
                        y_offset=row0, height=band)
                elif use_dense:
                    args, _, ov = dense.resolve_inputs(
                        None, None, *cam_args(cam), row0, **kw,
                        **dense.DenseBudget.of(cap).kwargs())
                if use_dense:
                    if args is None:
                        raise AssertionError(f"{label}: zero pair budget")
                    zk, ik = dense_kernel.resolve_dense_cuda(*args)
                    plain = dense_kernel.resolve_dense_plain
                else:
                    args, ov = tile_kernel.resolve_inputs(
                        None, None, *cam_args(cam), row0, **kw)
                    pargs = args
                    zk, ik = tile_kernel.resolve_tiles_cuda(*args)
                    plain = tile_kernel.resolve_tiles_plain
                where = (f"{label} band {b} of {n} (rows {row0}-"
                         f"{row0 + band - 1})")
                if int(ov):
                    raise AssertionError(f"{where} view {k}: overflow "
                                         f"{int(ov)}")
                assert_same_image(where + " == full render", k, zk, ik,
                                  z[row0:row0 + band], ids[row0:row0 + band])
                if k in plain_views:
                    zp, ip = plain(*pargs)
                    err = max(err, assert_same_image(where + " == plain", k,
                                                     zk, ik, zp, ip))
    torch.cuda.synchronize()
    kernel = "raster_dense" if use_dense else "raster_tile"
    phase(f"phase 7: {kernel} on row bands at {label}: {len(cams)} views "
          f"{width}x{height} in {BANDS} bands of "
          f"{[height // n for n in BANDS]} rows at y_offset = row0, every "
          f"band == the full render's rows (ids, depth bits), overflow 0; "
          f"== plain on every band of views {list(plain_views)}")
    return err


def face_block_check(device):
    """`scannet`'s triangles in 2 and 4 contiguous blocks, each rendered
    alone through kernel B (49686 and 24843 faces: still dense) and merged
    per pixel by (z bits, global id) minimum, the merge a `faces` axis does
    with two MIN all-reduces: equal to the full render on every view."""
    from semantic_meshes_torch import rasterize as rast

    vertices, faces, cams = scene("scannet")
    width, height = cams[0].resolution
    fv = face_vertices(vertices, faces, device)
    cap = dense_budget(vertices, faces, cams, device)
    for k, cam in enumerate(cams):
        ids, z, _ = rast.rasterize(vertices, faces, *cam_args(cam),
                                   face_vertices=fv, height=height,
                                   width=width, dense_e_cap=cap,
                                   device=device)
        for n in BANDS:
            blk = len(faces) // n
            if not rast.uses_dense(None, blk):
                raise AssertionError(f"scannet block of {blk} faces is not "
                                     "dense")
            zbits, tris = [], []
            for f in range(n):
                sl = slice(f * blk, (f + 1) * blk)
                t, zb, ov = rast.rasterize(
                    vertices, faces[sl], *cam_args(cam), face_vertices=fv[sl],
                    height=height, width=width, dense_e_cap=cap,
                    device=device)
                if int(ov):
                    raise AssertionError(f"scannet view {k} block {f} of "
                                         f"{n}: overflow {int(ov)}")
                zbits.append(zb.view(torch.int32))
                tris.append(torch.where(t >= 0, t + f * blk, NO_ID))
            zbits = torch.stack(zbits)
            zmin = zbits.amin(0)
            win = torch.where(zbits == zmin, torch.stack(tris), NO_ID).amin(0)
            win = torch.where(win < NO_ID, win, -1)
            if not (torch.equal(win, ids)
                    and torch.equal(zmin, z.view(torch.int32))):
                bad = int((win != ids).sum())
                raise AssertionError(f"scannet view {k}, {n} face blocks: "
                                     f"{bad} merged ids differ from the full "
                                     "render")
    phase(f"phase 7: scannet in {BANDS} face blocks of "
          f"{[len(faces) // n for n in BANDS]} triangles (raster_dense "
          f"each): merged by (z bits, global id) == the full render on all "
          f"{len(cams)} views, overflow 0")


def sharded_inputs(preset, device, indoor=False, lens=False, texels=False):
    """A sharded case's global inputs on `device` (the same on every rank:
    the scene from the preset, probabilities from SEED on the card), the
    keywords of make_sharded_fuse, and the one-card fusion to compare
    with: fuse_views, or fuse_views_texels, under
    plan_fuse(allow_split=False) (a sharded fuse has no face remap).
    indoor: the cameras inside the room, clip_near; lens: SIMPLE_RADIAL
    on every view, one physical camera (shared_lens); texels: the texel
    renderer's tables at TPP[preset]."""
    import semantic_meshes_torch as smt

    _, n_views, width, height, classes = SCENES[preset]
    vertices, faces, cams = (indoor_scene if indoor else scene)(preset)
    if lens:
        cams = with_lenses(cams, [RADIAL_SCANNET] * n_views)
    probs = device_probs(n_views, height, width, classes, device)
    rot, trans, fl, pp = smt.data.stack_cameras(cams)
    dists = smt.data.stack_distortions(cams) if lens else None
    P = len(faces)
    if texels:
        r = smt.render.texels(SimpleNamespace(vertices=vertices, faces=faces),
                              cams, TPP[preset], device=device)
        vertices, faces, P = r.vertices, r.faces, r.getPrimitivesNum()
    plan = smt.distributed.plan_fuse(
        vertices, faces, rot, trans, fl, pp, height=height, width=width,
        clip_near=indoor, distortions=dists, allow_split=False,
        device=device)
    kw = dict(num_primitives=P, aggregator="sum", height=height, width=width,
              clip_near=indoor, dense_e_cap=plan.dense_e_cap)
    args = [vertices, faces, rot, trans, fl, pp, probs, IEW]
    if lens:
        kw.update(with_distortion=True, shared_lens=True)
        args.append(dists)
    if texels:
        kw["texel_params"] = (r.resolutions, r.first_texel_index)

        def one_card():
            return smt.distributed.fuse_views_texels(
                vertices, faces, r.resolutions, r.first_texel_index, rot,
                trans, fl, pp, probs, IEW, num_primitives=P,
                aggregator="sum", height=height, width=width,
                clip_near=indoor, dense_e_cap=plan.dense_e_cap,
                device=device)
    else:
        def one_card():
            return smt.distributed.fuse_views(
                vertices, faces, rot, trans, fl, pp, probs, IEW,
                distortions=dists, shared_lens=lens, num_primitives=P,
                aggregator="sum", height=height, width=width,
                clip_near=indoor, dense_e_cap=plan.dense_e_cap,
                device=device)
    return args, kw, one_card


def world_of_one(device):
    """make_sharded_fuse at `scannet` in an NCCL world of one, layout (1,
    1): every collective is over one rank and skipped, so the fuse equals
    fuse_views bit for bit; overflow 0; raster_dense once per view. Both
    batches timed in turns (host clock around work that ends in a
    synchronize). Returns the launches of raster_dense and of the fusion
    kernels."""
    import torch.distributed as dist

    import semantic_meshes_torch as smt

    args, kw, one_card = sharded_inputs("scannet", device)
    smt.distributed.initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0,
                                         device=device)
    try:
        mesh = smt.distributed.make_device_mesh(device=device)
        log = []
        fuse = smt.distributed.make_sharded_fuse(mesh, collectives=log, **kw)
        ref, ref_ov = one_card()
        reset_launches()
        acc, ov = fuse(*args)
        torch.cuda.synchronize()
        launches = read_launches()
        fused = read_fusion()
        log = list(log)  # one batch's collectives
        if not torch.equal(acc, ref) or int(ov) != int(ref_ov) or int(ov):
            raise AssertionError(
                "world of one != fuse_views (max |err| "
                f"{float((acc - ref).abs().max())}, overflow {int(ov)})")
        if not log or not all(c.skipped for c in log):
            raise AssertionError(f"world of one moved data: {log}")
        expect_launches("scannet world of one", launches, "raster_dense",
                        len(args[2]))
        check_fusion("scannet world of one", fused, len(args[2]))
        fns = {"sharded": lambda: fuse(*args), "fuse_views": one_card}
        times = {name: [] for name in fns}  # both ran once above: warm
        for name in ("sharded", "fuse_views", "fuse_views", "sharded") * 3:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[name]()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    finally:
        dist.destroy_process_group()
    med = {k: statistics.median(v) for k, v in times.items()}
    phase(f"phase 7: make_sharded_fuse in an NCCL world of one at scannet "
          f"(1, 1): == fuse_views bit for bit, overflow 0, "
          f"{len(log)} collectives all skipped, launches {launches}, fusion "
          f"{fused}; batch "
          f"{med['sharded']:.6f} ms against fuse_views {med['fuse_views']:.6f}"
          f" ms in turns (ratio {med['sharded'] / med['fuse_views']:.6f})")
    return launches["raster_dense"], fused["launches"]


def sharded_cases(n):
    """(label, preset, layout, sharded_inputs options, make_sharded_fuse
    options) of the multi-card part for n cards; a layout needs n even
    where it halves n."""
    cases = [
        ("scannet views", "scannet", (n, 1), {}, {}),
        ("scannet views + shard_primitives", "scannet", (n, 1), {},
         {"shard_primitives": True}),
        ("large views x pixels", "large", (n // 2, 2), {}, {}),
        ("scannet faces", "scannet", (1, 1, n), {}, {}),
        ("scannet views x faces", "scannet", (n // 2, 1, 2), {}, {}),
        ("texels01 views x faces", "texels01", (n // 2, 1, 2),
         {"texels": True}, {}),
        ("scannet indoor + clip views", "scannet", (n, 1), {"indoor": True},
         {}),
        ("scannet + SIMPLE_RADIAL views", "scannet", (n, 1), {"lens": True},
         {}),
    ]
    return [c for c in cases if int(np.prod(c[2])) == n]


def nvlink_bytes_s():
    """(bytes/s each way of card 0's NVLink links, source): the sum of the
    link speeds `nvidia-smi nvlink -s` lists, else the data sheet's."""
    import re

    try:
        out = subprocess.run(["nvidia-smi", "nvlink", "-s", "-i", "0"],
                             capture_output=True, text=True, timeout=60)
        speeds = [float(x) for x in re.findall(r"([0-9.]+) GB/s", out.stdout)]
    except (OSError, subprocess.SubprocessError):
        speeds = []
    if speeds:
        return sum(speeds) * 1e9, (f"nvidia-smi nvlink -s: {len(speeds)} "
                                   f"links of {speeds[0]} GB/s")
    return NVLINK_BYTES_S, "NVIDIA data sheet (nvidia-smi listed no links)"


def collective_bound_ms(op, numel, k, bw):
    """Least time of a collective over k ranks: the bytes a rank sends
    (ring all-reduce 2 (k - 1) / k of the tensor, reduce-scatter
    (k - 1) / k of its input) over the link bandwidth each way."""
    share = 2 * (k - 1) / k if op.startswith("all_reduce") else (k - 1) / k
    return share * numel * 4 / bw * 1e3


def time_collectives(mesh, log, device, reps=10):
    """Each distinct collective of one batch's record, on tensors of its
    shape and dtype, timed with CUDA events (median of `reps`) on every
    rank at once; [(op, axes, shape, per batch count, ms, group size)]."""
    import collections

    import semantic_meshes_torch as smt

    counts = collections.Counter(
        (c.op, c.axes, c.in_shape) for c in log if not c.skipped)
    out = []
    for (op, axes, shape), count in sorted(counts.items()):
        axis = smt.distributed.MeshAxis(mesh, axes)
        dtype = torch.int32 if op.endswith("min") else torch.float32
        t = torch.ones(shape, dtype=dtype, device=device)

        def run():
            if op == "reduce_scatter":
                return axis.reduce_scatter(t)
            return axis.all_reduce(t.clone(), op[len("all_reduce_"):])

        ms = cuda_time_ms(run, reps)
        out.append((op, axes, shape, count, ms, axis.size))
    return out


def sharded_rank(rank, n, port, out_dir, bw):
    """One NCCL rank (card `rank`) of the multi-card part: every case of
    sharded_cases(n) twice (bit-identical), against the one-card fusion
    on this rank's card (its rows of it under shard_primitives), timed in
    turns with it on rank 0; rank 0 also traces one sharded batch and
    times each collective. Writes rank<rank>.json (or rank<rank>.err)."""
    import traceback

    sys.path.insert(0, HERE)
    try:
        result = sharded_rank_cases(rank, n, port, bw)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(result, fh)


def rank_prep_check(rank, n, device):
    """On card `rank`: the dense preparation of this rank's row band (one
    of n) of `scannet`'s first view, by the dense_prep kernels against the
    plain chain (dense_view_pair), and raster_dense on it against its
    plain version on the plain chain's."""
    from semantic_meshes_torch.rasterize import dense_kernel

    vertices, faces, cams = scene("scannet")
    fv = face_vertices(vertices, faces, device)
    cap = dense_budget(vertices, faces, cams, device)
    band = cams[0].resolution[1] // n
    args, pargs, ov = dense_view_pair(
        f"rank {rank}, scannet band {rank} of {n}", 0, fv, cams[0], cap,
        device, y_offset=rank * band, height=band)
    zk, ik = dense_kernel.resolve_dense_cuda(*args)
    zp, ip = dense_kernel.resolve_dense_plain(*pargs)
    torch.cuda.synchronize()
    assert_same_image(f"rank {rank} band", 0, zk, ik, zp, ip)
    print(f"phase 7 rank {rank} [{device}]: dense_prep == plain chain and "
          f"raster_dense == plain on band {rank} of {n} (rows "
          f"{rank * band}-{(rank + 1) * band - 1}) of scannet view 0, "
          f"overflow {int(ov)}", flush=True)


def sharded_rank_cases(rank, n, port, bw):
    import torch.distributed as dist

    import semantic_meshes_torch as smt

    device = torch.device("cuda", rank)
    smt.distributed.initialize_multihost(f"127.0.0.1:{port}", n, rank,
                                         device=device)
    rank_prep_check(rank, n, device)
    meshes, results = {}, []
    for label, preset, layout, opts, fuse_opts in sharded_cases(n):
        args, kw, one_card = sharded_inputs(preset, device, **opts)
        kw.update(fuse_opts)
        if layout not in meshes:
            meshes[layout] = smt.distributed.make_device_mesh(*layout,
                                                              device=device)
        mesh = meshes[layout]
        log = []
        fuse = smt.distributed.make_sharded_fuse(mesh, collectives=log, **kw)
        ref, ref_ov = one_card()
        reset_launches()
        acc, ov = fuse(*args)
        torch.cuda.synchronize()
        launches = read_launches()
        launches["fusion"] = read_fusion()["launches"]
        batch_log = list(log)
        acc2, ov2 = fuse(*args)
        if fuse_opts.get("shard_primitives"):
            rows = acc.shape[0]
            ref = ref[rank * rows:(rank + 1) * rows]
        ok = bool(torch.allclose(acc, ref, rtol=SHARDED_RTOL,
                                 atol=SHARDED_ATOL))
        entry = {
            "label": label, "preset": preset, "layout": list(layout),
            "ok": ok and int(ov) == int(ref_ov),
            "bit_identical": bool(torch.equal(acc, acc2))
            and int(ov) == int(ov2),
            "max_abs_err": float((acc - ref).abs().max()),
            "bit_equal_to_one_card": bool(torch.equal(acc, ref)),
            "overflow": int(ov), "one_card_overflow": int(ref_ov),
            "launches": launches, "rows": int(acc.shape[0]),
            "primitives": kw["num_primitives"],
        }
        times = {"sharded": [], "one card": []}
        for name in ("sharded", "one card", "one card", "sharded") * 3:
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "sharded":
                fuse(*args)
            elif rank == 0:
                one_card()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            dist.barrier()
        entry["ms"] = {k: statistics.median(v) for k, v in times.items()}
        entry["busy_ms"] = traced_busy_ms(rank, lambda: fuse(*args))
        entry["collectives"] = [
            {"op": op, "axes": list(axes), "shape": list(shape),
             "per_batch": count, "ms": ms, "ranks": k,
             "bound_ms": collective_bound_ms(op, int(np.prod(shape)), k,
                                             bw)}
            for op, axes, shape, count, ms, k in time_collectives(
                mesh, batch_log, device)]
        entry["skipped"] = sum(c.skipped for c in batch_log)
        results.append(entry)
        del args, ref, acc, acc2, one_card
        torch.cuda.empty_cache()
    dist.barrier()
    dist.destroy_process_group()
    raise_prep_faults()
    return {"rank": rank, "device": torch.cuda.get_device_name(device),
            "cases": results}


def traced_busy_ms(rank, fn):
    """The device busy time of one sharded batch traced on rank 0 (the
    sum of its device events, NCCL's kernels included, and without
    them); the other ranks run the batch untraced. None on other ranks
    and where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    prof = None
    if rank == 0:
        try:
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
        except (RuntimeError, AssertionError):  # no device activity to trace
            prof = None
    fn()  # every rank, outside any try: its collectives need them all
    torch.cuda.synchronize()
    if prof is None:
        return None
    try:
        prof.stop()
        kernels = device_times(prof)
    except (RuntimeError, AttributeError):
        return None
    if not kernels:
        return None
    nccl = sum(ms for name, (ms, _) in kernels.items()
               if "nccl" in name.lower())
    total = sum(ms for ms, _ in kernels.values())
    return {"all": total, "without_nccl": total - nccl}


def multi_card(card, n):
    """The multi-card part: one NCCL rank per card (spawned processes, the
    kernels already built by phase 2), every case of sharded_cases(n).
    Prints a phase line per case and returns the launches of each path,
    summed over the ranks."""
    import multiprocessing

    bw, bw_source = nvlink_bytes_s()
    phase(f"phase 7: {n} cards, one NCCL rank each: "
          f"{'; '.join(card_lines())}; NVLink {bw / 1e9:.3f} GB/s each way "
          f"({bw_source})")
    torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    with tempfile.TemporaryDirectory() as out_dir:
        procs = [ctx.Process(target=sharded_rank,
                             args=(r, n, port, out_dir, bw))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + RANK_DEADLINE_S
        try:
            while any(p.is_alive() for p in procs):
                failed = [r for r, p in enumerate(procs)
                          if p.exitcode not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(1.0)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(timeout=60)
        errors = []
        for r in range(n):
            err = os.path.join(out_dir, f"rank{r}.err")
            if os.path.exists(err):
                with open(err) as fh:
                    errors.append(f"rank {r}:\n{fh.read()}")
        if errors or any(p.exitcode != 0 for p in procs):
            raise AssertionError(
                "multi-card ranks failed (exit codes "
                f"{[p.exitcode for p in procs]}):\n" + "\n".join(errors))
        ranks = []
        for r in range(n):
            with open(os.path.join(out_dir, f"rank{r}.json")) as fh:
                ranks.append(json.load(fh))
    by_path = {"raster_tile": {}, "raster_dense": {}, "fusion": {}}
    for i, entry in enumerate(ranks[0]["cases"]):
        each = [rk["cases"][i] for rk in ranks]
        bad = [e for e in each if not (e["ok"] and e["bit_identical"])]
        if bad:
            raise AssertionError(f"{entry['label']} {entry['layout']}: {bad}")
        layout = tuple(entry["layout"])
        path = f"{entry['label']} {layout}"
        for kernel in by_path:
            total = sum(e["launches"][kernel] for e in each)
            if total:
                by_path[kernel][path] = total
        if path not in by_path["fusion"]:
            raise AssertionError(f"{path}: no rank fused a view by the "
                                 "fusion kernels")
        _, views, width, height, _ = SCENES[entry["preset"]]
        ms = entry["ms"]
        mpix = {k: views * width * height / 1e6 / (v / 1e3)
                for k, v in ms.items()}
        busy = entry["busy_ms"]
        idle = ("not measured" if busy is None else
                f"{1 - busy['all'] / ms['sharded']:.6f} "
                f"({1 - busy['without_nccl'] / ms['sharded']:.6f} counting "
                "NCCL's kernels as idle)")
        colls = "; ".join(
            f"{c['op']} over {'x'.join(c['axes'])} ({c['ranks']} ranks) of "
            f"{tuple(c['shape'])} x{c['per_batch']}: {c['ms']:.6f} ms each, "
            f"bound {c['bound_ms']:.6f}" for c in entry["collectives"])
        phase(
            f"phase 7 [{card}]: {path}: == one card (max |err| "
            f"{max(e['max_abs_err'] for e in each):.3e}, bit-equal on "
            f"{sum(e['bit_equal_to_one_card'] for e in each)} of {n} ranks), "
            f"overflow {entry['overflow']} == {entry['one_card_overflow']}, "
            f"two runs bit-identical on every rank, {entry['rows']} rows a "
            f"rank of P {entry['primitives']}; batch {ms['sharded']:.6f} ms "
            f"({mpix['sharded']:.2f} MPix/s) against one card "
            f"{ms['one card']:.6f} ms ({mpix['one card']:.2f}) in turns, "
            f"{ms['one card'] / ms['sharded']:.6f}x; rank 0 idle share "
            f"{idle}; collectives a batch: {colls or 'none'} "
            f"({entry['skipped']} over one rank, skipped); launches summed "
            f"over ranks {[e['launches'] for e in each]}")
        print(json.dumps({
            "metric": "rasterize_fuse_throughput", "value": mpix["sharded"],
            "unit": "MPix/s", "card": card,
            "detail": {"preset": entry["preset"], "variant": path,
                       "cards": n, "views": views,
                       "resolution": [width, height],
                       "one_card_mpix_s": mpix["one card"],
                       "batch_ms": ms["sharded"],
                       "one_card_batch_ms": ms["one card"],
                       "busy_ms": busy, "collectives": entry["collectives"],
                       "devices": [rk["device"] for rk in ranks]}}),
              flush=True)
    return by_path


def multi_gpu(device, card):
    """Phase 7. Returns (max |depth error| of raster_tile and raster_dense
    against plain on bands, launches_by_path additions per kernel)."""
    t7 = time.monotonic()
    large_v, large_f, large_c = scene("large")
    tile_err = band_check("large", large_v, large_f, large_c, device,
                          range(len(large_c)))
    # kernel A at heights that are no tile multiple: `default`'s mesh
    # seen at `scannet`'s 1296x968 (bands of 484 and 242 rows)
    default_v, default_f, _ = scene("default")
    _, views, width, height, _ = SCENES["scannet"]
    from semantic_meshes_torch import testing

    cams = testing.make_ring_cameras(num_views=views, width=width,
                                     height=height)
    tile_err = max(tile_err, band_check("default mesh at 1296x968",
                                        default_v, default_f, cams, device,
                                        range(views)))
    scannet_v, scannet_f, scannet_c = scene("scannet")
    dense_err = band_check("scannet", scannet_v, scannet_f, scannet_c,
                           device, range(2))
    face_block_check(device)
    one = "scannet sharded, NCCL world of one (1, 1)"
    dense_launches, fusion_launches = world_of_one(device)
    by_path = {"raster_tile": {}, "raster_dense": {one: dense_launches},
               "fusion": {one: fusion_launches}}
    n = torch.cuda.device_count()
    if n >= 2:
        for kernel, paths in multi_card(card, n).items():
            by_path[kernel].update(paths)
    else:
        phase("phase 7: the multi-card part did not run: this machine has "
              f"{n} card (torch.cuda.device_count() == {n}), and NCCL puts "
              "one rank on a card")
    phase(f"phase 7 took {time.monotonic() - t7:.1f} s")
    return tile_err, dense_err, by_path


# ---------------------------------------------------------------- phase 8
# the bundled segmentation predictors (models.segmentation) at full width:
# bench.py's `e2e` preset (bench.py:317-400: UNet(64..512), 19 classes,
# Cityscapes' 2048x1024, texels at 0.1 per pixel on the cube s=64, 4 ring
# views, fuse_views_texels(predict_fn=), sum), the ScanNet eval's RGBD
# predictor (eval_scannet.py:222-239: 40 classes, input 480x640) at
# `scannet`, and the Cityscapes demo's PSPNet with sliding windows and
# scales (colorize_cityscapes_mesh.py:160-170, at input 512x512)
MODEL_WIDTHS = (64, 128, 256, 512)
E2E = dict(subdivisions=64, views=4, width=2048, height=1024, classes=19,
           tpp=0.1)
PSP_SCALES = (0.75, 1.0, 1.25)
# H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
# card == CPU bounds. Resizes: float32 of values in [0, 1], separable
# sums of a few weights (about 1e-6 is 8 ulp of 1.0). Models: both sides
# run the port's code and round the same bf16 convolutions, but cuDNN and
# oneDNN add in another order, so an activation that lands on a bf16
# rounding boundary moves by 2^-8. The bounds hold ~3x over the H100's
# readings at seed 0 (PERF.md): UNet(64..512) at 256x256 max |dprob|
# 0.0074, mean 3.0e-4, equal argmax 0.988; PSPNet 0.0015, 9.1e-5, 0.994;
# ConvBlock(256, 512) max |d| / max |x| 5.7e-3, mean 1.5e-4. (The CPU
# tests' looser bounds, tests/_torch_models.py, are between the JAX
# package and the port.) The float32 head: 64-term sums in float32 (TF32
# would show ~1e-3).
RESIZE_ATOL = 2e-6
PROB_ATOL = 0.02
PROB_MEAN = 1e-3
ARGMAX_SHARE = 0.98
BLOCK_RTOL = 0.02  # max |d| / max |x| of a ConvBlock's output
BLOCK_MEAN = 5e-4  # mean |d| / mean |x|
HEAD_RTOL = 1e-5


def probs_gap(label, got, want):
    """max and mean |dprob| and the share of equal argmax of card (got)
    and CPU (want) probabilities; raises past the bounds."""
    got = got.float().cpu()
    err = (got - want).abs()
    same = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    gap = dict(max=float(err.max()), mean=float(err.mean()), argmax=same)
    if (gap["max"] > PROB_ATOL or gap["mean"] > PROB_MEAN
            or same < ARGMAX_SHARE):
        raise AssertionError(f"{label}: card vs CPU {gap}, bounds "
                             f"{PROB_ATOL}, {PROB_MEAN}, {ARGMAX_SHARE}")
    return gap


def conv_flops(model, *inputs):
    """Operations of every convolution of one forward, from the shapes
    (2 x output elements x in channels x kernel area), counted by hooks."""
    from semantic_meshes_torch.models import segmentation

    total = [0]

    def count(conv, _args, out):
        cout, cin, kh, kw = conv.weight.shape
        total[0] += 2 * out.numel() * cin * kh * kw

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, segmentation.Conv)]
    try:
        with torch.inference_mode():
            model(*inputs)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def resizes_card_vs_cpu(device, card):
    """The predictors' resizes on the card against the CPU: the
    antialiased bilinear shrinks (ScanNet's 968x1296 colour to 480x640,
    Cityscapes' 1024x2048 to 512x512), the upsamples back (of 40 and 19
    classes of probabilities) and the UNet's 2x nearest."""
    from semantic_meshes_torch.models import segmentation

    rng = np.random.default_rng(SEED)
    cases = [("shrink 968x1296 -> 480x640", (968, 1296, 3), (480, 640),
              "bilinear"),
             ("shrink 1024x2048 -> 512x512", (1024, 2048, 3), (512, 512),
              "bilinear"),
             ("grow 480x640 -> 968x1296, 40 classes", (480, 640, 40),
              (968, 1296), "bilinear"),
             ("grow 512x512 -> 1024x2048, 19 classes", (512, 512, 19),
              (1024, 2048), "bilinear"),
             ("nearest 2x 512x1024, 64 channels", (512, 1024, 64),
              (1024, 2048), "nearest")]
    out = []
    for label, shape, hw, method in cases:
        x = torch.from_numpy(rng.random((1,) + shape, dtype=np.float32))
        want = segmentation.resize(x, hw, method)
        xd = x.to(device)
        got = segmentation.resize(xd, hw, method)
        err = float((got.cpu() - want).abs().max())
        if err > RESIZE_ATOL or (method == "nearest" and err != 0):
            raise AssertionError(f"resize {label}: card vs CPU {err}")
        ms = cuda_time_ms(lambda: segmentation.resize(xd, hw, method), 10)
        out.append(f"{label}: max |err| {err:.3e}, {ms:.6f} ms")
    phase(f"phase 8 [{card}]: resizes card == CPU (bound {RESIZE_ATOL}; "
          "nearest bit for bit): " + "; ".join(out))


def models_card_vs_cpu(device, card):
    """A full-width ConvBlock (the bottleneck's 256 -> 512 at a 512x512
    input's 64x64), the float32 head, and UNet(64..512) with 19 classes at
    256x256, each from seed 0, on the card against the CPU."""
    from semantic_meshes_torch.models import segmentation

    rng = np.random.default_rng(SEED)
    block = segmentation.init_(segmentation.ConvBlock(256, 512), SEED).eval()
    x = torch.from_numpy(rng.random((1, 256, 64, 64), dtype=np.float32))
    with torch.inference_mode():
        want = block(x)
        got = block.to(device)(x.to(device).contiguous(
            memory_format=torch.channels_last)).cpu()
    d = (got - want).abs()
    rel = float(d.max() / want.abs().max())
    mean = float(d.mean() / want.abs().mean())
    if rel > BLOCK_RTOL or mean > BLOCK_MEAN:
        raise AssertionError(f"ConvBlock(256, 512): card vs CPU max rel "
                             f"{rel}, mean rel {mean}")
    head = segmentation.init_(segmentation.Conv(64, 19, 1, bf16=False), SEED)
    x = torch.from_numpy(rng.standard_normal((1, 64, 256, 256),
                                             dtype=np.float32))
    with torch.inference_mode():
        want_h = head(x)
        got_h = head.to(device)(x.to(device)).cpu()
        before = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            tf32 = torch.nn.functional.conv2d(
                x.to(device), head.weight, head.bias).cpu()
        finally:
            torch.backends.cudnn.allow_tf32 = before
    scale = float(want_h.abs().max())
    head_err = float((got_h - want_h).abs().max()) / scale
    tf32_err = float((tf32 - want_h).abs().max()) / scale
    if head_err > HEAD_RTOL:
        raise AssertionError(f"float32 head: card vs CPU {head_err} "
                             f"(TF32 would give {tf32_err})")
    model = segmentation.init_(segmentation.UNet(19, MODEL_WIDTHS),
                               SEED).eval()
    img = torch.from_numpy(rng.random((1, 256, 256, 3), dtype=np.float32))
    with torch.inference_mode():
        want_p = torch.softmax(model(img), -1)
        model = model.to(device).to(memory_format=torch.channels_last)
        got_p = torch.softmax(model(img.to(device)), -1)
    gap = probs_gap("UNet(64..512) at 256x256", got_p, want_p)
    phase(f"phase 8 [{card}]: ConvBlock(256, 512) at 64x64 card vs CPU "
          f"max |d| / max |x| {rel:.3e} (bound {BLOCK_RTOL}), mean "
          f"{mean:.3e} (bound {BLOCK_MEAN}); float32 head 64 -> 19 at "
          f"256x256 {head_err:.3e} (bound {HEAD_RTOL}; with TF32 "
          f"{tf32_err:.3e}); UNet(64..512), 19 classes at 256x256: max "
          f"|dprob| {gap['max']:.6f}, mean {gap['mean']:.3e}, equal argmax "
          f"{gap['argmax']:.6f} (bounds {PROB_ATOL}, {PROB_MEAN}, "
          f"{ARGMAX_SHARE})")


def groupnorm_times(device, card):
    """The GroupNorm of the UNet's first stage at 2048x1024 (64 channels,
    32 groups, float32) three ways, in turns: the port's (channels_last,
    reduced in place), PyTorch's group_norm on NCHW, and group_norm on
    channels_last (which copies to NCHW first), against the bound of
    reading and writing the tensor once."""
    import torch.nn.functional as F

    from semantic_meshes_torch.models import segmentation

    gen = torch.Generator(device=device).manual_seed(SEED)
    x = torch.randn((1, 64, 1024, 2048), generator=gen, device=device)
    x_cl = x.contiguous(memory_format=torch.channels_last)
    norm = segmentation.GroupNorm(64).to(device)
    with torch.no_grad():
        norm.weight.normal_(1.0, 0.1, generator=gen)
        norm.bias.normal_(0.0, 0.1, generator=gen)

    def plain(t):
        return F.group_norm(t, norm.num_groups, norm.weight, norm.bias,
                            norm.eps)

    with torch.inference_mode():
        want = plain(x)
        err = float((norm(x_cl) - want).abs().max() / want.abs().max())
        if err > 1e-5:
            raise AssertionError(f"GroupNorm channels_last vs NCHW: {err}")
        runs = {"port, channels_last": lambda: norm(x_cl),
                "group_norm, NCHW": lambda: plain(x),
                "group_norm, channels_last": lambda: plain(x_cl)}
        times = {k: [] for k in runs}
        for _ in range(3):
            for k in list(runs) + list(runs)[::-1]:
                times[k].append(cuda_time_ms(runs[k], reps=1, warmup=1))
    bound = 2 * x.numel() * 4 / PEAK_BYTES_S * 1e3
    phase(f"phase 8 [{card}]: GroupNorm(64) of (1, 64, 1024, 2048) float32, "
          f"ms in turns (medians of 6): " + "; ".join(
              f"{k} {statistics.median(v):.6f}" for k, v in times.items())
          + f"; bound {bound:.6f} (bytes); port vs NCHW max |d| / max |y| "
          f"{err:.3e}")


def e2e_dense_vs_plain(renderer, cams, device):
    """raster_dense against its plain version on every `e2e` view, on the
    inputs the main path gives it: the texel renderer's reordered faces
    at the default budget (fuse_views_texels is called without
    dense_e_cap). Ids equal and depths bit-equal; overflow 0."""
    from semantic_meshes_torch.rasterize import dense_kernel

    for k, cam in enumerate(cams):
        args, pargs, overflow = dense_view_pair(
            "e2e", k, renderer.face_vertices, cam, None, device)
        if args is None:
            raise AssertionError("e2e: zero pair budget")
        zk, ik = dense_kernel.resolve_dense_cuda(*args)
        zp, ip = dense_kernel.resolve_dense_plain(*pargs)
        torch.cuda.synchronize()
        if int(overflow) != 0:
            raise AssertionError(f"e2e view {k}: overflow {int(overflow)}")
        assert_same_image("e2e", k, zk, ik, zp, ip)
        del args, pargs, zk, ik, zp, ip
    return len(cams)


def tile_scene_vs_plain(label, renderer, cams, device):
    """raster_tile against its plain version on every view of `cams`, on
    the inputs the main path gives it (the renderer's face vertices, no
    clipping): ids equal and depths bit-equal, overflow 0."""
    from semantic_meshes_torch.rasterize import tile_kernel

    for k, cam in enumerate(cams):
        args, overflow = view_inputs(renderer.face_vertices, cam, device)
        zk, ik = tile_kernel.resolve_tiles_cuda(*args)
        zp, ip = tile_kernel.resolve_tiles_plain(*args)
        torch.cuda.synchronize()
        if int(overflow) != 0:
            raise AssertionError(f"{label} view {k}: overflow "
                                 f"{int(overflow)}")
        assert_same_image(label, k, zk, ik, zp, ip)
    return len(cams)


def e2e_preset(device, card, workdir):
    """bench.py's e2e preset through the port: texels, the UNet's softmax
    as fuse_views_texels' predict_fn on raw uint8 views, sum fusion.
    Returns (raster_dense's launches in the run the counters read,
    e2e_image_time in ms)."""
    import semantic_meshes_torch as smt
    from semantic_meshes_torch.models import segmentation

    W, H, C, n = E2E["width"], E2E["height"], E2E["classes"], E2E["views"]
    vertices, faces = smt.testing.make_cube(subdivisions=E2E["subdivisions"])
    path = os.path.join(workdir, "e2e.ply")
    smt.io.ply.write_mesh(path, vertices, faces)
    mesh = smt.data.Ply(path)
    cams = smt.testing.make_ring_cameras(num_views=n, width=W, height=H)
    rng = np.random.default_rng(SEED)
    imgs = torch.from_numpy(rng.integers(0, 255, (n, H, W, 3),
                                         np.uint8)).to(device)
    rot, trans, fl, pp = smt.data.stack_cameras(cams)

    reset_launches()
    renderer = smt.render.texels(mesh, cams, E2E["tpp"], bucket=True,
                                 device=device)
    P = renderer.getPrimitivesNum()
    model = segmentation.load_predictor(classes=C, input_hw=(H, W),
                                        device=device).model

    @torch.inference_mode()
    def predict_fn(img):
        x = img.to(torch.float32) / 255.0
        return torch.softmax(model(x[None])[0], dim=-1)

    def fuse(probs, predict=None):
        return smt.distributed.fuse_views_texels(
            renderer.vertices, renderer.faces, renderer.resolutions,
            renderer.first_texel_index, rot, trans, fl, pp, probs, IEW,
            num_primitives=P, aggregator="sum", height=H, width=W,
            predict_fn=predict, device=device)

    def run_batch():
        return fuse(imgs, predict_fn)

    acc, overflow = run_batch()
    torch.cuda.synchronize()
    launches = read_launches()
    if launches != {"raster_tile": 0, "raster_dense": n}:
        raise AssertionError(f"e2e: launches {launches}, expected "
                             f"raster_dense once a view")
    if int(overflow) != 0:
        raise AssertionError(f"e2e: overflow {int(overflow)}")
    if tuple(acc.shape) != (P, C) or not torch.isfinite(acc).all():
        raise AssertionError(f"e2e: accumulator {tuple(acc.shape)}")
    # outside the counted run: the kernel against its plain version
    checked = e2e_dense_vs_plain(renderer, cams, device)
    seen = float((acc.abs().sum(-1) > 0).float().mean())
    probs = torch.stack([predict_fn(img) for img in imgs])
    sums = probs.sum(-1)
    if not torch.allclose(sums, torch.ones_like(sums), atol=1e-3):
        raise AssertionError("e2e: predictions do not sum to 1")
    pre, pre_overflow = fuse(probs)
    same = torch.equal(acc, pre)
    if not same:
        err = float((acc - pre).abs().max())
        if not torch.allclose(acc, pre, rtol=2e-5, atol=0):
            raise AssertionError(f"e2e: predict_fn != precomputed probs "
                                 f"(max |err| {err})")
    del probs, pre
    again, _ = run_batch()
    if not torch.equal(acc, again):
        raise AssertionError("e2e: two runs are not bit-identical")
    del again

    # bench.py's e2e_image_time: min over timed batches / views, with one
    # scalar read back per batch
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        acc, _ = run_batch()
        acc[0, 0].item()
        times.append(time.perf_counter() - t0)
    image_ms = min(times) / n * 1e3
    median_ms = statistics.median(times) / n * 1e3
    predict_ms = cuda_time_ms(lambda: predict_fn(imgs[0]), reps=5)
    flops = conv_flops(model, imgs[:1].to(torch.float32) / 255.0)
    share = flops / (predict_ms / 1e3) / PEAK_BF16_FLOPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    run_batch()
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    batch_ms = statistics.median(times) * 1e3
    phase(f"phase 8 [{card}]: e2e ok: {n} views {W}x{H}, cube s="
          f"{E2E['subdivisions']} ({len(faces)} triangles), {P} texels, "
          f"UNet{MODEL_WIDTHS}, {C} classes, overflow 0, launches "
          f"{launches} (raster_dense once a view), raster_dense == plain on "
          f"all {checked} views (ids equal, depths bit-equal, default "
          f"budget), predict_fn == the fusion "
          f"of the stacked predictions (bit-equal: {same}), two runs "
          f"bit-identical, {seen:.6f} of the texels seen; e2e_image_time "
          f"{image_ms:.6f} ms/image (min of 5 batches / views; median "
          f"{median_ms:.6f}), the predictor alone {predict_ms:.6f} ms/image "
          f"(CUDA events), its convolutions {flops / 1e12:.6f} TFLOP/image "
          f"= {flops / (predict_ms / 1e3) / 1e12:.3f} TFLOP/s, "
          f"{share:.6f} of the {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16 "
          f"peak; peak device memory {peak_gb:.3f} GB a batch")
    device_busy("e2e", "fuse_views_texels(predict_fn=)", run_batch,
                batch_ms, card, tag="phase 8")
    print(json.dumps({
        "metric": "e2e_image_time", "value": image_ms, "unit": "ms/image",
        "card": card,
        "detail": {"preset": "e2e", "views": n, "resolution": [W, H],
                   "triangles": len(faces), "texels": P, "classes": C,
                   "widths": list(MODEL_WIDTHS), "overflow": 0,
                   "batch_ms": [t * 1e3 for t in times],
                   "median_ms_per_image": median_ms,
                   "predict_ms": predict_ms, "conv_tflop": flops / 1e12,
                   "bf16_peak_share": share, "peak_gb": peak_gb}}),
          flush=True)
    return launches["raster_dense"], image_ms


def rgbd_scannet(device, card):
    """eval_scannet.py's --model jax-unet path at `scannet`: the RGBD
    predictor (40 classes, input 480x640) on seeded 1296x968 colour and
    the port's own render in mm at 640x480, through fuse_views(probs=
    (colors, depths), predict_fn=) against the per-view predict -> render
    -> MeshAggregator.add path. Returns raster_dense's launches in the
    batched run."""
    import semantic_meshes_torch as smt
    from semantic_meshes_torch.models import segmentation

    _, n_views, width, height, classes = SCENES["scannet"]
    vertices, faces, cams = scene("scannet")
    T = len(faces)
    renderer = smt.render.triangles(
        SimpleNamespace(vertices=vertices, faces=faces), device=device)
    renderer.prepare(cams)
    cap = renderer.dense_cap_policy._cap[(height, width)]
    depths = []
    for cam in cams:
        depth = renderer.render(cam)[1].t()
        mm = torch.where(torch.isfinite(depth), depth * 1000.0,
                         torch.zeros_like(depth))
        mm = torch.clamp(torch.round(mm), 0, 65535).to(torch.int32)
        depths.append(smt.data2.scannet._resize_nearest(
            mm.cpu().numpy().astype("<u2"), EVAL_DEPTH_HW).astype(np.int32))
    depths = torch.from_numpy(np.stack(depths)).to(device)
    rng = np.random.default_rng(SEED)
    colors = torch.from_numpy(rng.integers(
        0, 256, (n_views, height, width, 3), np.uint8)).to(device)
    predict = segmentation.load_rgbd_predictor(
        classes=classes, input_hw=EVAL_DEPTH_HW, widths=MODEL_WIDTHS,
        device=device)
    rot, trans, fl, pp = smt.data.stack_cameras(cams)

    def batch():
        return smt.distributed.fuse_views(
            vertices, faces, rot, trans, fl, pp, (colors, depths), IEW,
            num_primitives=T, aggregator="sum", height=height, width=width,
            dense_e_cap=cap, predict_fn=lambda pr: predict(*pr),
            device=device)

    reset_launches()
    acc, overflow = batch()
    torch.cuda.synchronize()
    launches = read_launches()
    if launches != {"raster_tile": 0, "raster_dense": n_views}:
        raise AssertionError(f"scannet RGBD: launches {launches}")
    if int(overflow) != 0:
        raise AssertionError(f"scannet RGBD: overflow {int(overflow)}")
    agg = smt.fusion.MeshAggregator(T, classes, "sum", IEW, device=device)
    for k, cam in enumerate(cams):
        probs = predict(colors[k], depths[k])
        if tuple(probs.shape) != (height, width, classes):
            raise AssertionError(f"scannet RGBD: probs {probs.shape}")
        agg.add(renderer.render(cam)[0], probs.transpose(0, 1))
    if renderer.overflow_total() != 0:
        raise AssertionError("scannet RGBD: per-view overflow")
    if not torch.allclose(acc, agg.state, rtol=1e-6, atol=0.0):
        err = float((acc - agg.state).abs().max())
        raise AssertionError(f"scannet RGBD: batched != per-view ({err})")
    predict_ms = cuda_time_ms(lambda: predict(colors[0], depths[0]), 5)
    batch_ms = cuda_time_ms(batch, 3)
    flops = conv_flops(predict.model,
                       torch.zeros((1,) + EVAL_DEPTH_HW + (3,),
                                   device=device),
                       torch.zeros((1,) + EVAL_DEPTH_HW + (1,),
                                   device=device))
    phase(f"phase 8 [{card}]: scannet RGBD eval ok: {n_views} frames of "
          f"{width}x{height} colour and {EVAL_DEPTH_HW[1]}x"
          f"{EVAL_DEPTH_HW[0]} depth (the port's render, mm), RGBDUNet"
          f"{MODEL_WIDTHS}, {classes} classes at {EVAL_DEPTH_HW}, dense "
          f"budget {cap}; fuse_views(probs=(colors, depths), predict_fn=) "
          f"== per-view predict -> render -> add (bit-equal: "
          f"{torch.equal(acc, agg.state)}), overflow 0, launches "
          f"{launches}; predictor {predict_ms:.6f} ms a frame ("
          f"{flops / 1e12:.6f} TFLOP of convolutions, "
          f"{flops / (predict_ms / 1e3) / PEAK_BF16_FLOPS:.6f} of the bf16 "
          f"peak), batch {batch_ms / n_views:.6f} ms a frame")
    return launches["raster_dense"]


def pspnet_demo(device, card):
    """colorize_cityscapes_mesh.py's predictor: PSPNet(64..512), 19
    classes, input 512x512, sliding (512, 512) windows, scales
    PSP_SCALES, on one 2048x1024 image; and the same composition on the
    card against the CPU on a 256x512 crop."""
    from semantic_meshes_torch.models import segmentation

    kw = dict(classes=19, arch="pspnet", input_hw=(512, 512),
              widths=MODEL_WIDTHS, sliding=(512, 512),
              multi_scale=PSP_SCALES)
    predict = segmentation.load_predictor(**kw, device=device)
    rng = np.random.default_rng(SEED)
    img = rng.integers(0, 256, (1024, 2048, 3)).astype(np.uint8)
    img_d = torch.from_numpy(img).to(device)
    probs = predict(img_d)
    if tuple(probs.shape) != (1024, 2048, 19):
        raise AssertionError(f"pspnet: probs {tuple(probs.shape)}")
    sums = probs.sum(-1)
    if not torch.allclose(sums, torch.ones_like(sums), atol=1e-3):
        raise AssertionError("pspnet: probabilities do not sum to 1")
    ms = cuda_time_ms(lambda: predict(img_d), reps=3, warmup=1)
    crop = img[:256, :512]
    cpu = segmentation.load_predictor(
        **kw, params={k: v.cpu() for k, v in predict.params.items()},
        device="cpu")
    gap = probs_gap("pspnet at 256x512", predict(crop), cpu(crop))
    phase(f"phase 8 [{card}]: pspnet demo ok: PSPNet{MODEL_WIDTHS}, 19 "
          f"classes, input 512x512, sliding (512, 512) x scales "
          f"{PSP_SCALES} on 2048x1024: shape (1024, 2048, 19), sums 1 "
          f"within 1e-3, {ms:.6f} ms an image; card vs CPU at 256x512: max "
          f"|dprob| {gap['max']:.6f}, mean {gap['mean']:.3e}, equal argmax "
          f"{gap['argmax']:.6f}")


def models_phase(device, card):
    """Phase 8. Returns (launches_by_path additions per kernel,
    e2e_image_time in ms)."""
    t8 = time.monotonic()
    resizes_card_vs_cpu(device, card)
    models_card_vs_cpu(device, card)
    groupnorm_times(device, card)
    with tempfile.TemporaryDirectory() as workdir:
        e2e, e2e_ms = e2e_preset(device, card, workdir)
    rgbd = rgbd_scannet(device, card)
    pspnet_demo(device, card)
    phase(f"phase 8 took {time.monotonic() - t8:.1f} s")
    return ({"raster_dense": {"e2e": e2e, "scannet RGBD eval": rgbd}},
            e2e_ms)


# ---------------------------------------------------------------- phase 9
# segmentation training (models.training) and the ScanNet eval entry point
# (eval_scannet.evaluate_scene) on the card. The trainer runs at the eval's
# full width: RGBDUNet(64, 128, 256, 512), 40 classes, input 480x640
# (eval_scannet.py's --model_widths and --model_input_hw defaults), batches
# of 8 frames, test_trained_fusion.py's learning rate 3e-3. It trains on
# frames of the `scannet` cube (s=91, 99372 triangles, 8 ring views of
# 1296x968) coloured by cube side (that test's class colours, a smooth
# per-frame illumination field and iid noise; depth from the port's
# render in mm at 640x480), and the eval fuses VIEW_FRAMES frames a view
# with the trained weights. The frames stay in memory and evaluate_scene
# runs without the CLI's file IO, so the run needs no imageio (no JPEG or
# PNG codec). Then the trained-fusion test's own scene (cube s=3, 108 triangles, 6
# views of 128x96, RGBDUNet(8, 16, 32)) through the same core, where
# raster_tile carries the renders.
TRAIN_BATCH = 8
TRAIN_LR = 3e-3
TRAIN_STEPS = 40
TRAIN_HW = EVAL_DEPTH_HW
VIEW_FRAMES = 3
ILLUM = 0.45
NOISE = 40.0
# test_trained_fusion.py's colours of the nyu ids 1..6 (0: background)
CLASS_COLORS = ((20, 20, 20), (200, 60, 60), (60, 200, 60), (60, 60, 200),
                (200, 200, 60), (200, 60, 200), (60, 200, 200))
SMALL_HW = (96, 128)  # the card vs CPU step, at full width
SMALL_STEPS = 60  # the trained-fusion scene, as its CPU test trains
# card vs CPU step bounds: the loss as the CPU tests bound JAX vs port
# (tests/test_torch_training.py, readings 2.9e-5 - 1.7e-4 there); the
# head's weight gradient from the same captured inputs in float32 (TF32
# would show ~1e-3); every element of (card dp - CPU dp) within 2 lr +
# 1e-6 (Adam's first update is ~+-lr whatever the gradient's size, so
# that bound holds even for a wrong backward), and a share of them within
# lr / 10 (read 0.996136 on the H100; the CPU tests' JAX vs port readings
# 0.990 - 0.994); a wrong gradient moves most elements by O(lr)
STEP_RTOL = 1e-3
HEAD_GRAD_RTOL = 1e-5
STEP_SHARE = 0.98


def class_frames(cams, renderer, face_class, frames_per_view, depth_hw,
                 seed, device):
    """For each view, frames_per_view frames (camera, colour (H, W, 3)
    uint8, depth (depth_hw) int32 mm, gt labels (H, W) int32 with -1 off
    the mesh) from the port's render of `face_class` (nyu ids 1..6 per
    face): colour = CLASS_COLORS[class] x (1 + ILLUM x a 3x4 field
    upsampled) + N(0, NOISE), clipped, one field and noise draw a frame,
    made on the card from a torch.Generator(seed)."""
    from semantic_meshes_torch.models import segmentation

    gen = torch.Generator(device=device).manual_seed(seed)
    fc = torch.as_tensor(np.asarray(face_class), device=device)
    palette = torch.tensor(CLASS_COLORS, dtype=torch.float32, device=device)
    frames = []
    for cam in cams:
        ids, depth = renderer.render(cam)
        ids = ids.view(torch.int32).t()
        H, W = ids.shape
        cls = torch.where(ids >= 0, fc[ids.clamp(min=0).long()], 0)
        gt = (cls - 1).to(torch.int32)
        d = depth.t()
        mm = torch.where(torch.isfinite(d), d * 1000.0, torch.zeros_like(d))
        mm = segmentation.resize(mm.round().clamp(0, 65535)[None, ..., None],
                                 depth_hw, "nearest")[0, ..., 0]
        for _ in range(frames_per_view):
            g = torch.randn((3, 4, 3), generator=gen, device=device)
            field = g.repeat_interleave(-(-H // 3), 0).repeat_interleave(
                -(-W // 4), 1)[:H, :W]
            color = palette[cls.long()] * (1.0 + ILLUM * field)
            color = color + NOISE * torch.randn(color.shape, generator=gen,
                                                device=device)
            frames.append((cam, color.clamp(0, 255).to(torch.uint8),
                           mm.to(torch.int32), gt))
    return frames


def train_batch(frames, input_hw):
    """The predictor's inputs of frames (load_rgbd_predictor's resizes:
    colour / 255 and depth x 1e-3 bilinear to the colour's size, both
    bilinear to input_hw) and their labels (nearest), as a train batch."""
    from semantic_meshes_torch.models import segmentation

    rgb, dep, lab = [], [], []
    for _, color, mm, gt in frames:
        hw = tuple(color.shape[:2])
        d = segmentation._resize_bilinear(
            mm.to(torch.float32)[..., None] * 1e-3, hw)
        rgb.append(color.to(torch.float32) / 255.0)
        dep.append(d)
        lab.append(gt.to(torch.float32)[..., None])
    image = segmentation.resize(torch.stack(rgb), input_hw)
    depth = segmentation.resize(torch.stack(dep), input_hw)
    labels = segmentation.resize(torch.stack(lab), input_hw, "nearest")
    return {"image": image, "depth": depth,
            "labels": labels[..., 0].to(torch.int32)}


def head_grad_check(trainer, batch, device):
    """One train_step with the float32 head's input and output gradient
    captured: its weight gradient on the card against the CPU's from the
    same captured tensors (float32, no TF32 there) and against float64.
    Returns (loss, relative error vs CPU, vs float64, TF32's error)."""
    head = trainer.model.layers.head
    saved = {}

    def forward_hook(_module, inputs, out):
        saved["x"] = inputs[0].detach()
        out.register_hook(lambda g: saved.__setitem__("g", g.detach()))

    hook = head.register_forward_hook(forward_hook)
    try:
        loss = trainer.train_step(batch)
    finally:
        hook.remove()
    gw = head.weight.grad.detach().clone()
    x, g = saved["x"], saved["g"]
    shape = tuple(head.weight.shape)
    conv_wgrad = torch.nn.grad.conv2d_weight
    cpu = conv_wgrad(x.cpu(), shape, g.cpu())
    exact = torch.einsum("bihw,bohw->oi", x.double(),
                         g.double())[..., None, None]
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = conv_wgrad(x, shape, g)
    finally:
        torch.backends.cudnn.allow_tf32 = before
    scale = float(exact.abs().max())

    def rel(a):
        return float((a.double().cpu() - exact.cpu()).abs().max()) / scale

    return (loss, float((gw.cpu() - cpu).abs().max()) / float(
        cpu.abs().max()), rel(gw), rel(tf32))


def step_card_vs_cpu(batch, device):
    """One step of a full-width trainer on the card and on the CPU from
    the same params, on the batch's first 2 frames shrunk to SMALL_HW:
    (card loss, CPU loss, max |card dp - CPU dp|, share within lr / 10)."""
    from semantic_meshes_torch.models import segmentation
    from semantic_meshes_torch.models.training import SegmentationTrainer

    small = {"image": segmentation.resize(batch["image"][:2], SMALL_HW),
             "depth": segmentation.resize(batch["depth"][:2], SMALL_HW),
             "labels": segmentation.resize(
                 batch["labels"][:2, ..., None].float(), SMALL_HW,
                 "nearest")[..., 0].to(torch.int32)}
    kw = dict(classes=40, input_hw=SMALL_HW, arch="rgbd",
              widths=MODEL_WIDTHS, learning_rate=TRAIN_LR, seed=SEED + 1)
    card = SegmentationTrainer(**kw, device=device)
    cpu = SegmentationTrainer(**kw, device="cpu")
    before = {k: v.detach().cpu().clone() for k, v in card.params.items()}
    loss_card = card.train_step(small)
    loss_cpu = cpu.train_step({k: v.cpu() for k, v in small.items()})
    err = torch.cat([((card.params[k].cpu() - before[k])
                      - (cpu.params[k] - before[k])).abs().reshape(-1)
                     for k in before])
    return (loss_card, loss_cpu, float(err.max()),
            float((err <= TRAIN_LR / 10).float().mean()))


def step_parts(trainer, batch, reps=3):
    """Median device ms of a train step's forward (with the loss),
    backward and AdamW update, from CUDA events around each, with TF32
    off as train_step holds it."""
    from semantic_meshes_torch.models import segmentation
    from semantic_meshes_torch.models.training import softmax_xent_ignore

    labels = batch["labels"].to(torch.int64)
    parts = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        with segmentation._ieee_f32():
            trainer.optimizer.zero_grad(set_to_none=True)
            ev[0].record()
            loss = softmax_xent_ignore(trainer._forward(batch), labels)
            ev[1].record()
            loss.backward()
            ev[2].record()
            trainer.optimizer.step()
            ev[3].record()
        torch.cuda.synchronize()
        parts.append([ev[k].elapsed_time(ev[k + 1]) for k in range(3)])
    return [statistics.median(p[k] for p in parts) for k in range(3)]


def dp_world_of_one(batch, device):
    """make_data_parallel_step in an NCCL world of one against single-card
    steps from the same params and batch. cuDNN's weight gradients may
    add in another order from run to run, so three single-card steps give
    the noise floor (max |dp| difference over their pairs) the data-
    parallel step is held to (twice it, plus 1e-7). Returns (noise, the
    data-parallel step's max |dp| difference, the losses)."""
    import torch.distributed as dist

    import semantic_meshes_torch as smt
    from semantic_meshes_torch.models.training import (
        SegmentationTrainer, make_data_parallel_step)

    kw = dict(classes=40, input_hw=TRAIN_HW, arch="rgbd",
              widths=MODEL_WIDTHS, learning_rate=TRAIN_LR, seed=SEED + 2)

    def single():
        tr = SegmentationTrainer(**kw, device=device)
        loss = tr.train_step(batch)
        return loss, {k: v.detach().clone() for k, v in tr.params.items()}

    runs = [single() for _ in range(3)]

    def diff(a, b):
        return max(float((a[k] - b[k]).abs().max()) for k in a)

    noise = max(diff(runs[i][1], runs[j][1])
                for i, j in ((0, 1), (0, 2), (1, 2)))
    smt.distributed.initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0,
                                         device=device)
    try:
        mesh = smt.distributed.make_device_mesh(device=device)
        tr = SegmentationTrainer(**kw, device=device)
        loss = make_data_parallel_step(tr, mesh)(batch)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    dp = diff({k: v.detach() for k, v in tr.params.items()}, runs[0][1])
    if dp > 2 * noise + 1e-7:
        raise AssertionError(f"DP world of one: max |dp| {dp} past twice "
                             f"the single-card noise {noise}")
    losses = [r[0] for r in runs] + [loss]
    if max(losses) - min(losses) > 1e-6 * abs(losses[0]):
        raise AssertionError(f"DP world of one: losses {losses}")
    return noise, dp, losses


def scannet_class_scene():
    """(vertices, faces, cameras, face classes (nyu 1..6 by cube side),
    raw vertex labels) of the `scannet` cube, as the eval's labelled
    meshes carry them (testing._write_labeled_cube_ply)."""
    vertices, faces, cams = scene("scannet")
    face_class = np.arange(len(faces)) // (len(faces) // 6) + 1
    vertex_labels = np.zeros(len(vertices), np.int64)
    vertex_labels[faces.reshape(-1)] = np.repeat(face_class, 3)
    return vertices, faces, cams, face_class, vertex_labels


def eval_in_memory(args, mesh, frames, predict, session, vertex_gt=None):
    """eval_scannet.evaluate_scene over in-memory frames ((camera,
    colour, depth, gt) each, indices in order) with the ids of both
    passes compared: returns (evaluate_scene's result, launches, the
    number of id images compared, the valid gt pixels)."""
    from semantic_meshes_torch import eval_scannet

    cameras = [(i, f[0]) for i, f in enumerate(frames)]
    seen = {}

    def on_ids(kind, index, ids):
        ids = ids.view(torch.int32)
        if kind == "fuse":
            seen[index] = ids.clone()
        elif not torch.equal(ids, seen.pop(index)):
            raise AssertionError(f"frame {index}: the fused re-render's ids "
                                 "differ from the fuse pass's")

    def decoded(start):
        for i in range(start, len(frames)):
            cam, color, depth, gt = frames[i]
            yield i, cam, color, depth, gt, None

    reset_launches()
    result = eval_scannet.evaluate_scene(
        "scene", mesh, cameras, decoded, predict, session, args,
        labels=lambda i: frames[i][3], vertex_gt=vertex_gt, on_ids=on_ids)
    torch.cuda.synchronize()
    launches = read_launches()
    if seen:
        raise AssertionError(f"frames {sorted(seen)} not re-rendered")
    valid = sum(int((f[3] >= 0).sum()) for f in frames)
    for name in ("image_network", "image_fused"):
        total = float(session.groups[name][0].full_matrix.sum())
        if total != valid:
            raise AssertionError(f"{name}: confusion matrix holds {total} "
                                 f"pixels, the frames {valid} valid")
    return result, launches, len(frames), valid


def phase_ms(timers, frames):
    """Each PhaseTimers phase in ms a frame (its total over the frames)."""
    return {k: round(v * 1e3 / frames, 6) for k, v in timers.totals.items()}


def train_full_width(device, card, workdir):
    """The trainer at full width on the `scannet` class frames, the card
    vs CPU gates, the DP world of one and the save -> load round trip.
    Returns (trainer, params path, scene, frames)."""
    import semantic_meshes_torch as smt
    from semantic_meshes_torch.models import segmentation
    from semantic_meshes_torch.models.training import SegmentationTrainer

    vertices, faces, cams, face_class, vertex_labels = \
        scannet_class_scene()
    renderer = smt.render.triangles(
        SimpleNamespace(vertices=vertices, faces=faces), device=device)
    renderer.prepare(cams)
    frames = class_frames(cams, renderer, face_class, VIEW_FRAMES,
                          EVAL_DEPTH_HW, SEED, device)
    batch = train_batch(frames[::VIEW_FRAMES], TRAIN_HW)  # frame 0 a view
    if len(batch["labels"]) != TRAIN_BATCH:
        raise AssertionError(f"train batch of {len(batch['labels'])}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    tr = SegmentationTrainer(classes=40, input_hw=TRAIN_HW, arch="rgbd",
                             widths=MODEL_WIDTHS, learning_rate=TRAIN_LR,
                             seed=SEED, device=device)
    first, head_cpu, head_f64, head_tf32 = head_grad_check(tr, batch, device)
    if head_cpu > HEAD_GRAD_RTOL:
        raise AssertionError(f"head weight gradient: card vs CPU {head_cpu} "
                             f"(TF32 gives {head_tf32})")
    losses, ms = [first], []
    for _ in range(TRAIN_STEPS - 1):
        loss, t = timed(lambda: tr.train_step(batch))
        losses.append(loss)
        ms.append(t)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    if not losses[-1] < 0.7 * losses[0]:
        raise AssertionError(f"training: loss {losses[0]} -> {losses[-1]}")
    step_ms = statistics.median(ms[2:])
    fwd_ms, bwd_ms, adam_ms = step_parts(tr, batch)
    flops = 3 * conv_flops(tr.model, batch["image"], batch["depth"])
    phase(f"phase 9 [{card}]: trainer RGBDUNet{MODEL_WIDTHS}, 40 classes, "
          f"batch {TRAIN_BATCH} x {TRAIN_HW}, lr {TRAIN_LR}: loss "
          f"{losses[0]:.6f} -> {losses[-1]:.6f} in {TRAIN_STEPS} steps "
          f"(< 0.7x); step {step_ms:.6f} ms (median of {len(ms) - 2}), "
          f"{TRAIN_BATCH / (step_ms / 1e3):.3f} frames/s; fwd+bwd conv "
          f"{flops / 1e12:.6f} TFLOP (3x the forward), "
          f"{flops / (step_ms / 1e3) / PEAK_BF16_FLOPS:.6f} of the bf16 "
          f"peak; peak memory {peak_gb:.3f} GB; forward + loss "
          f"{fwd_ms:.6f} ms, backward {bwd_ms:.6f} ms, AdamW {adam_ms:.6f} "
          f"ms (medians of 3); float32 head weight gradient card vs CPU "
          f"{head_cpu:.3e} (bound {HEAD_GRAD_RTOL}), vs float64 "
          f"{head_f64:.3e}, with TF32 {head_tf32:.3e}")
    device_busy("train step", "train_step", lambda: tr.train_step(batch),
                step_ms, card, tag="phase 9")

    loss_card, loss_cpu, dp_err, share = step_card_vs_cpu(batch, device)
    if abs(loss_card - loss_cpu) > STEP_RTOL * abs(loss_cpu):
        raise AssertionError(f"one step: loss card {loss_card} CPU "
                             f"{loss_cpu}")
    if dp_err > 2 * TRAIN_LR + 1e-6:
        raise AssertionError(f"one step: max |card dp - CPU dp| {dp_err}")
    if share < STEP_SHARE:
        raise AssertionError(f"one step: {share} of |card dp - CPU dp| "
                             f"within lr/10, below {STEP_SHARE}")
    noise, dp, dp_losses = dp_world_of_one(batch, device)
    path = os.path.join(workdir, "rgbd.msgpack")
    tr.save(path)
    predict = segmentation.load_rgbd_predictor(
        classes=40, params_path=path, widths=MODEL_WIDTHS,
        input_hw=TRAIN_HW, device=device)
    for k, v in tr.params.items():
        if not torch.equal(v, predict.params[k]):
            raise AssertionError(f"save -> load_rgbd_predictor: {k}")
    phase(f"phase 9 [{card}]: one step at full width, batch 2 x "
          f"{SMALL_HW}: loss card {loss_card:.7f} CPU {loss_cpu:.7f} "
          f"(rel {abs(loss_card - loss_cpu) / abs(loss_cpu):.3e}, bound "
          f"{STEP_RTOL}); max |card dp - CPU dp| {dp_err:.3e} (bound "
          f"{2 * TRAIN_LR + 1e-6}), {share:.6f} within lr/10 (bound "
          f"{STEP_SHARE}); "
          f"make_data_parallel_step in an NCCL world of one: max |dp - "
          f"single| {dp:.3e} against a two-run noise of {noise:.3e}, losses "
          f"{[round(x, 7) for x in dp_losses]}; save -> "
          f"load_rgbd_predictor(params_path=) bit-equal "
          f"({len(tr.params)} tensors)")
    return path, (vertices, faces, cams, vertex_labels), frames


def eval_scannet_scale(device, card, path, scannet, frames):
    """evaluate_scene at `scannet` with the trained predictor (--model
    jax-unet --params, mul, triangles): raster_dense twice a frame, the
    ids of both passes equal, overflow 0, fused mIoU > network mIoU.
    Returns raster_dense's launches."""
    from semantic_meshes_torch import eval_scannet

    vertices, faces, cams, vertex_labels = scannet
    args = eval_scannet.parse_args([
        "--scannet", ".", "--model", "jax-unet", "--params", path,
        "--aggregator", "mul", "--timings", "--device", str(device)])
    predict = eval_scannet.make_predictor(args, device)
    session = eval_scannet.Session(eval_scannet.result_params(args), device)
    mesh = SimpleNamespace(vertices=vertices, faces=faces)
    result, launches, n, valid = eval_in_memory(
        args, mesh, frames, predict, session,
        vertex_gt=(faces.astype(np.int64), vertex_labels))
    expect_launches("scannet eval entry", launches, "raster_dense", 2 * n)
    if result["overflow"]:
        raise AssertionError(f"scannet eval entry: overflow "
                             f"{result['overflow']}")
    metrics = session.results()
    net = metrics["image_network"]["mean_iou"]
    fused = metrics["image_fused"]["mean_iou"]
    if not fused > net:
        raise AssertionError(f"scannet eval entry: fused mIoU {fused} <= "
                             f"network {net}")
    width, height = (int(r) for r in cams[0].resolution)
    phase(f"phase 9 [{card}]: scannet eval entry (trained RGBD) ok: "
          f"{len(cams)} views x {VIEW_FRAMES} frames of {width}x{height} "
          f"({len(faces)} triangles, mul, triangles mode): raster_dense "
          f"{launches['raster_dense']} launches (2 a frame), the re-render's "
          f"ids == the fuse pass's, overflow 0, matrices sum to the {valid} "
          f"valid pixels; network mIoU {net:.6f} (accuracy "
          f"{metrics['image_network']['accuracy']:.6f}), fused {fused:.6f} "
          f"(accuracy {metrics['image_fused']['accuracy']:.6f}), vertex "
          f"{metrics['vertex']['mean_iou']:.6f}; ms a frame by phase "
          f"{json.dumps(phase_ms(session.timers, n))}")
    return launches["raster_dense"]


def trained_fusion_scene(device, card):
    """tests/test_trained_fusion.py's scene at its own size on the card
    (cube s=3, 6 views of 128x96, RGBDUNet(8, 16, 32), 60 steps at lr
    3e-3, mul), frames in memory: fused mIoU >= network mIoU, raster_tile
    twice a frame. Returns raster_tile's launches."""
    import semantic_meshes_torch as smt
    from semantic_meshes_torch import eval_scannet
    from semantic_meshes_torch.models.training import SegmentationTrainer

    H, W, widths = 96, 128, (8, 16, 32)
    vertices, faces = smt.testing.make_cube(subdivisions=3)
    cams = smt.testing.make_ring_cameras(num_views=6, width=W, height=H,
                                         radius=3.0)
    face_class = np.arange(len(faces)) // (len(faces) // 6) + 1
    mesh = SimpleNamespace(vertices=vertices, faces=faces)
    renderer = smt.render.triangles(mesh, device=device)
    frames = class_frames(cams, renderer, face_class, 1, (H, W), SEED,
                          device)
    batch = train_batch(frames, (H, W))
    tr = SegmentationTrainer(classes=40, input_hw=(H, W), arch="rgbd",
                             widths=widths, learning_rate=TRAIN_LR,
                             seed=SEED, device=device)
    first = tr.train_step(batch)
    for _ in range(SMALL_STEPS - 1):
        last = tr.train_step(batch)
    with tempfile.TemporaryDirectory() as workdir:
        path = os.path.join(workdir, "small.msgpack")
        tr.save(path)
        args = eval_scannet.parse_args([
            "--scannet", ".", "--model", "jax-unet", "--params", path,
            "--model_widths", "8,16,32", "--model_input_hw", f"{H},{W}",
            "--aggregator", "mul", "--device", str(device)])
        predict = eval_scannet.make_predictor(args, device)
    session = eval_scannet.Session(eval_scannet.result_params(args), device)
    result, launches, n, _ = eval_in_memory(args, mesh, frames, predict,
                                            session)
    expect_launches("trained fusion scene", launches, "raster_tile", 2 * n)
    if result["overflow"]:
        raise AssertionError(f"trained fusion scene: overflow "
                             f"{result['overflow']}")
    # the eval builds its renderer bucketed (108 faces -> 1024 rows): hold
    # the kernel to plain on those rows
    checked = tile_scene_vs_plain(
        "trained fusion scene",
        smt.render.triangles(mesh, bucket=True, device=device), cams, device)
    metrics = session.results()
    net = metrics["image_network"]["mean_iou"]
    fused = metrics["image_fused"]["mean_iou"]
    if not fused >= net:
        raise AssertionError(f"trained fusion scene: fused mIoU {fused} < "
                             f"network {net}")
    phase(f"phase 9 [{card}]: trained fusion scene ok: {len(faces)} "
          f"triangles, {n} frames of {W}x{H}, RGBDUNet{widths} loss "
          f"{first:.6f} -> {last:.6f} in {SMALL_STEPS} steps; raster_tile "
          f"{launches['raster_tile']} launches (2 a frame), overflow 0, "
          f"raster_tile == plain on its {checked} views at the eval's "
          f"bucketed rows (ids equal, depths bit-equal); network mIoU "
          f"{net:.6f}, fused {fused:.6f}")
    return launches["raster_tile"]


def training_phase(device, card):
    """Phase 9. Returns launches_by_path additions per kernel."""
    t9 = time.monotonic()
    with tempfile.TemporaryDirectory() as workdir:
        path, scannet, frames = train_full_width(device, card, workdir)
        dense = eval_scannet_scale(device, card, path, scannet, frames)
    del frames
    tile = trained_fusion_scene(device, card)
    phase(f"phase 9 took {time.monotonic() - t9:.1f} s")
    return {"raster_dense": {"scannet eval entry (trained RGBD)": dense},
            "raster_tile": {"trained fusion scene": tile}}


# ------------------------------------------------------------------ phase 10

# bench_cityscapes' defaults: the Cityscapes frame size, 19 classes, cube
# s=64 (49152 triangles: raster_dense), f16 maps from seeds 1001..1020
CITY = dict(views=20, subdivisions=64, width=2048, height=1024)
PRE_VIEWS = 4  # precompute_probs' views (UNet(64..512) at 2048x1024)
PRE_TOPK = 3
TOPK_SHARE = 0.99  # faces whose top-3 colour equals the dense one
# The bundled UNet's random init gives near-uniform maps (top-1 ~0.12;
# the top 3 hold over half the mass on 0.06% of pixels, so a top-3 store
# is don't-care almost everywhere: on random-noise views the top-3
# colour differed from the dense one on 1.3% of the faces). So the UNet is
# trained first, as a user's would be: PRE_STEPS AdamW steps (lr PRE_LR)
# on batches of PRE_BATCH mosaics at its 512x512 input, blocks of
# PRE_BLOCK pixels each of one class in its Cityscapes colour +
# N(0, PRE_NOISE); the views are such mosaics at 2048x1024 (blocks 4x
# larger, as the predictor's resize shrinks them), and precompute_probs
# reads the trained weights from the trainer's flax msgpack.
PRE_STEPS = 60
PRE_LR = 3e-3
PRE_BATCH = 4
PRE_BLOCK = 16
PRE_NOISE = 12.0
REMAP_CLASSES = 24  # colorize_mesh --remap's class count (>= colours)
SCRIPT_TIMEOUT_S = 600


def script_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (HERE, env.get("PYTHONPATH")) if p)
    return env


def counted(fn, *args):
    """fn(*args) with every launch counter set to 0 just before it and
    read just after: (result, launches)."""
    torch.cuda.synchronize()
    reset_launches()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, read_launches()


def ply_colors(path):
    from semantic_meshes_torch.io.ply import read_ply

    e = read_ply(str(path))
    return np.stack([e["face"].data[c] for c in ("red", "green", "blue")],
                    -1)


def run_script(module, args, label, failures):
    """`python -m semantic_meshes_torch.scripts.<module> args` on the
    card; returns its last stdout line as JSON (None on failure)."""
    t = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", f"semantic_meshes_torch.scripts.{module}"]
        + [str(a) for a in args], env=script_env(), cwd=HERE,
        capture_output=True, text=True, timeout=SCRIPT_TIMEOUT_S)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        failures.append(f"{label}: rc {proc.returncode}")
        print(proc.stdout[-3000:] + proc.stderr[-3000:], flush=True)
        return None
    result = json.loads(lines[-1])
    phase(f"phase 10: {label} ({time.monotonic() - t:.1f} s): "
          + json.dumps(result))
    return result


def check(failures, ok, message, tag="phase 10"):
    """Record a failed gate (every gate of phases 10 and 11 runs; the
    phase raises at its end)."""
    if not ok:
        failures.append(message)
        phase(f"{tag}: FAILED: {message}")
    return ok


def city_paths(root):
    return SimpleNamespace(
        ws=os.path.join(root, "ws"), mesh=os.path.join(root, "mesh.ply"),
        images=os.path.join(root, "images"),
        probs=os.path.join(root, "probs-f16"))


def cityscapes_demo(device, root, failures):
    """colorize_cityscapes_mesh --probs at bench_cityscapes' defaults,
    chunked and per view; both == a fusion of raster_dense's plain ids;
    then bench_cityscapes' probs and unet legs in processes."""
    from semantic_meshes_torch import data, fusion, probs_io, render
    from semantic_meshes_torch.rasterize import dense_kernel
    from semantic_meshes_torch.scripts import bench_cityscapes as bench
    from semantic_meshes_torch.scripts import colorize_cityscapes_mesh as demo
    from semantic_meshes_torch.utils import CLASS_TO_COLOR

    t = time.monotonic()
    faces = bench.build_scene(root, **CITY)
    bench.write_workspace(root, views=CITY["views"], width=CITY["width"],
                          height=CITY["height"], cam_model="PINHOLE")
    bench.ensure_probs(root, "f16", views=CITY["views"], width=CITY["width"],
                       height=CITY["height"], device=device)
    p = city_paths(root)
    phase(f"phase 10: Cityscapes scene ({faces} triangles, {CITY['views']} "
          f"views of {CITY['width']}x{CITY['height']}, f16 maps made on the "
          f"card) in {time.monotonic() - t:.1f} s")
    base = ["--colmap", p.ws, "--input_ply", p.mesh, "--images", p.images,
            "--probs", p.probs, "--probs_dtype", "f16", "--device", "cuda"]
    runs, by_path, fused_by_path = {}, {}, {}
    for chunk, label in ((0, "chunked"), (1, "per view")):
        out = os.path.join(root, f"demo_chunk{chunk}.ply")
        args = demo.parse_args(base + ["--output_ply", out,
                                       "--chunk", str(chunk)])
        t = time.monotonic()
        result, launches = counted(demo.run, args)
        fused = read_fusion()
        wall = time.monotonic() - t
        runs[chunk] = result
        by_path[f"cityscapes demo ({label})"] = launches["raster_dense"]
        fused_by_path[f"cityscapes demo ({label})"] = fused["launches"]
        timers = {k: round(v["median_s"] * 1e3, 3) for k, v in
                  result["timers"].as_dict().items()}
        phase(f"phase 10: colorize_cityscapes_mesh --chunk {chunk} in "
              f"process: {wall:.1f} s ({wall / CITY['views']:.4f} s/image), "
              f"launches {launches}, fusion {fused}, overflow "
              f"{result['overflow']}, phase medians ms {timers}")
        check(failures, result["overflow"] == 0,
              f"demo chunk {chunk}: overflow {result['overflow']}")
        check(failures, launches == {"raster_tile": 0,
                                     "raster_dense": CITY["views"]},
              f"demo chunk {chunk}: launches {launches}")
        # the chunked run also fuses the all-zero views padding its tail
        check(failures, fused["views"] >= CITY["views"],
              f"demo chunk {chunk}: fusion {fused} for {CITY['views']} "
              "views")
        check(failures, np.array_equal(ply_colors(out), result["colors"]),
              f"demo chunk {chunk}: PLY colours != the run's")
    check(failures, np.array_equal(runs[0]["colors"], runs[1]["colors"]),
          "demo: chunked colours != per-view colours")

    # the same fusion from raster_dense's plain version's ids
    mesh, ws = data.Ply(p.mesh), data.Colmap(p.ws)
    files = sorted(os.listdir(p.images))
    cams = [ws.getCamera(f) for f in files]
    fv = face_vertices(mesh.vertices, mesh.faces, device)
    cap = dense_budget(mesh.vertices, mesh.faces, cams, device)
    agg = fusion.MeshAggregator(len(mesh.faces), demo.CLASSES, "sum",
                                device=device)
    renderer = render.triangles(mesh, device=device)
    renderer.prepare(cams)
    err, t = 0.0, time.monotonic()
    for k, (f, cam) in enumerate(zip(files, cams)):
        args, pargs, overflow = dense_view_pair("cityscapes demo", k, fv,
                                                cam, cap, device)
        if not check(failures, args is not None,
                     f"demo view {k}: zero pair budget (no kernel)"):
            continue
        zk, ik = dense_kernel.resolve_dense_cuda(*args)
        zp, ip = dense_kernel.resolve_dense_plain(*pargs)
        torch.cuda.synchronize()
        err = max(err, assert_same_image("cityscapes demo", k, zk, ik, zp,
                                         ip))
        check(failures, int(overflow) == 0, f"demo view {k}: overflow")
        ids = renderer.render(cam)[0].view(torch.int32).t()
        check(failures, torch.equal(ids, ip),
              f"demo view {k}: render() ids != plain ids")
        probs = probs_io.densify(probs_io.load(
            os.path.join(p.probs, os.path.splitext(f)[0]), "f16", device))
        agg.add(ip.t(), probs.transpose(0, 1))
        del args, pargs, zk, ik, zp, ip, ids, probs
    fused = agg.get().cpu().numpy()
    plain = np.where((fused.sum(-1) < demo.DONT_CARE_THRESHOLD)[:, None],
                     np.uint8(0), CLASS_TO_COLOR[fused.argmax(-1)])
    seen = int(fused.sum(-1).astype(bool).sum())
    check(failures, np.array_equal(plain, runs[0]["colors"]),
          "demo: colours != the plain-id fusion's")
    phase(f"phase 10: demo chunked == per view == the fusion of "
          f"resolve_dense_plain's ids on all {len(cams)} views (kernel ids "
          f"== plain, depths bit-equal; {seen} faces seen) "
          f"[{time.monotonic() - t:.1f} s]")
    del agg, renderer, fv
    torch.cuda.empty_cache()
    bench_lines = {leg: run_script(
        "bench_cityscapes", ["--keep", root, "--leg", leg, "--device", "cuda"],
        f"bench_cityscapes --leg {leg}", failures)
        for leg in ("probs", "unet")}
    return by_path, err, bench_lines, fused_by_path


def mosaics(gen, n, height, width, block, device):
    """n (height, width, 3) float32 images of block x block squares, each
    of a random Cityscapes class in its colour + N(0, PRE_NOISE), clipped
    to [0, 255] and rounded, and their (n, height, width) int32 labels;
    made on the card from `gen`."""
    from semantic_meshes_torch.utils import CLASS_TO_COLOR

    palette = torch.as_tensor(CLASS_TO_COLOR, dtype=torch.float32,
                              device=device)
    cls = torch.randint(0, len(palette), (n, height // block, width // block),
                        generator=gen, device=device)
    cls = cls.repeat_interleave(block, 1).repeat_interleave(block, 2)
    noise = torch.randn((n, height, width, 3), generator=gen, device=device)
    image = (palette[cls] + PRE_NOISE * noise).clamp(0, 255).round()
    return image, cls.to(torch.int32)


def precompute_leg(device, workdir, failures):
    """precompute_probs with the bundled UNet(64..512) at 2048x1024: f32
    maps == load_predictor in process bit for bit; f16 and top-3 stores
    through colorize_cityscapes_mesh --probs."""
    from semantic_meshes_torch.io.image import imread, imwrite
    from semantic_meshes_torch.models import segmentation
    from semantic_meshes_torch.models.training import SegmentationTrainer
    from semantic_meshes_torch.scripts import bench_cityscapes as bench
    from semantic_meshes_torch.scripts import colorize_cityscapes_mesh as demo
    from semantic_meshes_torch.scripts import precompute_probs

    root = os.path.join(workdir, "precompute")
    size = dict(width=CITY["width"], height=CITY["height"])
    bench.build_scene(root, views=PRE_VIEWS,
                      subdivisions=CITY["subdivisions"], **size)
    bench.write_workspace(root, views=PRE_VIEWS, cam_model="PINHOLE", **size)
    images = os.path.join(root, "images")
    gen = torch.Generator(device=device).manual_seed(SEED)
    t = time.monotonic()
    trainer = SegmentationTrainer(19, input_hw=(512, 512), arch="unet",
                                  widths=MODEL_WIDTHS, learning_rate=PRE_LR,
                                  seed=SEED, device=device)
    losses = []
    for _ in range(PRE_STEPS):
        image, labels = mosaics(gen, PRE_BATCH, 512, 512, PRE_BLOCK, device)
        losses.append(trainer.train_step({"image": image / 255.0,
                                          "labels": labels}))
    params = os.path.join(root, "unet.msgpack")
    trainer.save(params)
    del trainer
    phase(f"phase 10: UNet{MODEL_WIDTHS} trained {PRE_STEPS} steps on "
          f"{PRE_BATCH} mosaics of 512x512 (loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}) in {time.monotonic() - t:.1f} s")
    scale = CITY["width"] // 512
    for i in range(1, PRE_VIEWS + 1):
        image, _ = mosaics(gen, 1, CITY["height"], CITY["width"],
                           PRE_BLOCK * scale, device)
        imwrite(os.path.join(images, f"v{i:03d}.png"),
                image[0].to(torch.uint8).cpu().numpy())
    stores = {"f32": ["--dtype", "float32"], "f16": ["--dtype", "float16"],
              f"top{PRE_TOPK}": ["--topk", str(PRE_TOPK)]}
    for name, extra in stores.items():
        t = time.monotonic()
        precompute_probs.main(["--images", images, "--out",
                               os.path.join(root, name), "--params", params,
                               "--device", "cuda"] + extra)
        phase(f"phase 10: precompute_probs {' '.join(extra)}: "
              f"{(time.monotonic() - t) / PRE_VIEWS:.4f} s/image "
              f"(model build included)")
    predict = segmentation.load_predictor(classes=19, params_path=params,
                                          device=device)
    for f in sorted(os.listdir(images)):
        want = predict(imread(os.path.join(images, f))).cpu().numpy()
        got = np.load(os.path.join(root, "f32",
                                   os.path.splitext(f)[0] + ".npy"))
        check(failures, got.dtype == np.float32 and np.array_equal(got, want),
              f"precompute {f}: f32 map != load_predictor's")
    del predict
    colors = {}
    for name in ("f16", f"top{PRE_TOPK}"):
        colors[name] = demo.run(demo.parse_args([
            "--colmap", os.path.join(root, "ws"), "--input_ply",
            os.path.join(root, "mesh.ply"), "--images", images,
            "--output_ply", os.path.join(root, f"{name}.ply"), "--probs",
            os.path.join(root, name), "--device", "cuda"]))["colors"]
    share = float(np.all(colors["f16"] == colors[f"top{PRE_TOPK}"],
                         -1).mean())
    check(failures, share >= TOPK_SHARE,
          f"precompute: top-{PRE_TOPK} colour share {share} < {TOPK_SHARE}")
    phase(f"phase 10: precompute_probs (the trained UNet{MODEL_WIDTHS}, "
          f"--params msgpack) f32 maps == load_predictor bit for bit on "
          f"{PRE_VIEWS} views; faces with the top-{PRE_TOPK} colour "
          f"== the f16 colour: {share:.6f} (gate {TOPK_SHARE})")


def annotation_views(renderer, cams, fused, label_dir, names, device,
                     threshold=0.5):
    """Every label PNG == the argmax of ModelRenderer over the ids the
    renderer gives in process (255 at mass <= threshold); returns the
    (id, label) pairs of covered pixels and the number of mismatching
    views."""
    from semantic_meshes_torch import fusion
    from semantic_meshes_torch.io.image import imread

    mr = fusion.ModelRenderer(fused, device=device)
    pairs, bad = [], 0
    for name, cam in zip(names, cams):
        ids = renderer.render(cam)[0].view(torch.int32).t()  # (H, W)
        probs = mr.render(ids)
        cls = probs.argmax(-1).to(torch.uint8)
        want = torch.where(probs.sum(-1) > threshold, cls,
                           torch.full_like(cls, 255))
        got = torch.from_numpy(imread(os.path.join(
            label_dir, os.path.splitext(name)[0] + ".png"))).to(device)
        bad += int(not torch.equal(got, want))
        cov = ids >= 0
        pairs.append(torch.stack([ids[cov].long(), got[cov].long()], -1))
    return torch.cat(pairs), bad


def annotations_leg(device, root, failures):
    """render_annotations on the Cityscapes scene, triangles and texels at
    0.1: the PNGs == the in-process re-render, each face one label in
    every view that sees it."""
    from semantic_meshes_torch import data, render
    from semantic_meshes_torch.io.image import imwrite
    from semantic_meshes_torch.scripts import render_annotations

    p = city_paths(root)
    mesh, ws = data.Ply(p.mesh), data.Colmap(p.ws)
    names = [ws.getImageName(i) for i in range(ws.getImageNum())]
    cams = [ws.getCamera(n) for n in names]
    tri_class = torch.from_numpy(
        (np.arange(len(mesh.faces)) * 7) % 19).to(device)
    masks = os.path.join(root, "masks")
    os.makedirs(masks)
    renderer = render.triangles(mesh, device=device)
    renderer.prepare(cams)
    for name, cam in zip(names, cams):
        ids = renderer.render(cam)[0].view(torch.int32).t()
        imwrite(os.path.join(masks, name), torch.where(
            ids >= 0, tri_class[ids.clamp(min=0).long()], 0).to(
                torch.uint8).cpu().numpy())
    by_path = {}
    for label, extra in (("render_annotations", []),
                         ("render_annotations texels 0.1",
                          ["--texels_per_pixel", "0.1"])):
        out = os.path.join(root, label.replace(" ", "_"))
        npz = out + ".npz"
        t = time.monotonic()
        _, launches = counted(render_annotations.main, [
            "--colmap", p.ws, "--input_ply", p.mesh, "--classes", "19",
            "--masks", masks, "--output_dir", out, "--save_fused", npz,
            "--device", "cuda"] + extra)
        wall = time.monotonic() - t
        by_path[label] = launches["raster_dense"]
        check(failures, launches == {"raster_tile": 0,
                                     "raster_dense": 2 * len(cams)},
              f"{label}: launches {launches}")
        fused = torch.from_numpy(np.load(npz)["fused"]).to(device)
        r = render.texels(mesh, cams, 0.1, device=device) if extra \
            else renderer
        r.prepare(cams)
        pairs, bad = annotation_views(r, cams, fused,
                                      os.path.join(out, "labels"), names,
                                      device)
        check(failures, bad == 0,
              f"{label}: {bad} label PNGs != the in-process re-render")
        check(failures, r.overflow_total() == 0, f"{label}: overflow")
        pairs = torch.unique(pairs, dim=0)
        prims = torch.unique(pairs[:, 0])
        check(failures, len(prims) == len(pairs),
              f"{label}: {len(pairs) - len(prims)} primitives with two "
              "labels across views")
        if not extra:
            check(failures, torch.equal(pairs[:, 1],
                                        tri_class[pairs[:, 0]]),
                  f"{label}: a face's label != its mask class")
        phase(f"phase 10: {label}: {wall:.1f} s ({wall / len(cams):.4f} s a "
              f"view, fuse + re-render + 2 PNGs), launches {launches}, "
              f"{len(prims)} primitives seen, each one label in every view; "
              "label PNGs == the in-process ModelRenderer argmax")
        del fused, r
    return by_path


def same_files(failures, label, a, b):
    """Every file of directory a byte-equal to b's; returns the count."""
    names = sorted(os.listdir(a))
    check(failures, names == sorted(os.listdir(b)),
          f"{label}: file lists differ")
    differ = []
    for name in names:
        with open(os.path.join(a, name), "rb") as f, \
                open(os.path.join(b, name), "rb") as g:
            if f.read() != g.read():
                differ.append(name)
    check(failures, not differ, f"{label}: card != CPU in {differ}")
    return len(names)


def card_vs_cpu_ids(failures, label, mesh, cams, device):
    """The card's render ids == the CPU's on every view."""
    from semantic_meshes_torch import render

    card = render.triangles(mesh, device=device)
    cpu = render.triangles(mesh, device="cpu")
    for k, cam in enumerate(cams):
        a = card.render(cam)[0].view(torch.int32).cpu()
        b = cpu.render(cam)[0].view(torch.int32)
        check(failures, torch.equal(a, b),
              f"{label} view {k}: {int((a != b).sum())} ids card != CPU")


def tile_scripts_leg(device, workdir, failures):
    """demo_cube at its defaults and colorize_mesh --remap at bench.py's
    `default`, each on the card and on the CPU: the same files."""
    from semantic_meshes_torch import data, testing
    from semantic_meshes_torch.io.image import imwrite
    from semantic_meshes_torch.io.ply import write_mesh
    from semantic_meshes_torch.scripts import bench_cityscapes as bench
    from semantic_meshes_torch.scripts import colorize_mesh, demo_cube

    by_path = {}
    dirs = {d: os.path.join(workdir, f"demo_cube_{d}")
            for d in ("cuda", "cpu")}
    t = time.monotonic()
    _, launches = counted(demo_cube.main, ["--out", dirs["cuda"],
                                           "--device", "cuda"])
    card_s = time.monotonic() - t
    demo_cube.main(["--out", dirs["cpu"], "--device", "cpu"])
    by_path["demo_cube"] = launches["raster_tile"]
    defaults = demo_cube.parse_args([])
    check(failures, launches == {"raster_tile": 2 * defaults.views,
                                 "raster_dense": 0},
          f"demo_cube: launches {launches}")
    n = same_files(failures, "demo_cube", dirs["cuda"], dirs["cpu"])
    card_vs_cpu_ids(failures, "demo_cube",
                    data.Ply(os.path.join(dirs["cpu"], "cube.ply")),
                    testing.make_ring_cameras(
                        num_views=defaults.views, width=defaults.size,
                        height=defaults.size), device)
    phase(f"phase 10: demo_cube (s={defaults.subdivisions}, "
          f"{defaults.views} views of {defaults.size}x{defaults.size}) "
          f"{card_s:.1f} s on the card, launches {launches}; its {n} files "
          "card == CPU byte for byte, ids card == CPU")

    sub, views, width, height, _ = SCENES["default"]
    root = os.path.join(workdir, "colorize_mesh")
    vertices, faces = testing.make_cube(sub)
    os.makedirs(root)
    write_mesh(os.path.join(root, "mesh.ply"), vertices, faces)
    bench.write_workspace(root, views=views, width=width, height=height,
                          cam_model="PINHOLE")
    mesh, ws = data.Ply(os.path.join(root, "mesh.ply")), data.Colmap(
        os.path.join(root, "ws"))
    cams = [ws.getCamera(i) for i in range(views)]
    palette = np.stack([np.arange(19) * 13 % 256, np.arange(19) * 29 % 256,
                        np.arange(19) * 53 % 256], -1).astype(np.uint8)
    palette[0] = 7
    masks = os.path.join(root, "masks")
    os.makedirs(masks)
    from semantic_meshes_torch import render

    cpu = render.triangles(mesh, device="cpu")
    for i, cam in enumerate(cams):
        ids = cpu.render(cam)[0].view(torch.int32).numpy().T
        img = np.zeros(ids.shape + (3,), np.uint8)
        img[ids >= 0] = palette[(ids[ids >= 0] * 7) % 19]
        imwrite(os.path.join(masks, ws.getImageName(i)), img)
    plys = {}
    for d in ("cuda", "cpu"):
        plys[d] = os.path.join(root, f"{d}.ply")
        args = ["--colmap", os.path.join(root, "ws"), "--input_ply",
                os.path.join(root, "mesh.ply"), "--masks", masks,
                "--classes", str(REMAP_CLASSES), "--output_ply", plys[d],
                "--remap", "--device", d]
        t = time.monotonic()
        if d == "cuda":
            _, launches = counted(colorize_mesh.main, args)
        else:
            colorize_mesh.main(args)
        phase(f"phase 10: colorize_mesh --remap on the {d} "
              f"({len(faces)} triangles, {views} views of {width}x{height}):"
              f" {time.monotonic() - t:.1f} s")
    by_path["colorize_mesh"] = launches["raster_tile"]
    check(failures, launches == {"raster_tile": views, "raster_dense": 0},
          f"colorize_mesh: launches {launches}")
    with open(plys["cuda"], "rb") as f, open(plys["cpu"], "rb") as g:
        check(failures, f.read() == g.read(),
              "colorize_mesh: PLY card != CPU")
    card_vs_cpu_ids(failures, "colorize_mesh", mesh, cams, device)
    phase(f"phase 10: colorize_mesh --remap PLY card == CPU byte for byte, "
          f"launches {launches}, ids card == CPU")
    return by_path


def eval_cli_leg(workdir, failures):
    """The eval entry point on the card through its own CLI: the kill test
    (SIGKILL at the first manifest, resume == straight, exactly) and
    bench_eval at its defaults."""
    kill = run_script("resume_killtest", [
        "--workdir", os.path.join(workdir, "killtest"), "--device", "cuda"],
        "resume_killtest", failures)
    check(failures, kill is not None and kill["killtest"] == "PASS",
          f"resume_killtest: {kill}")
    return kill, run_script("bench_eval", [
        "--keep", os.path.join(workdir, "bench_eval"), "--device", "cuda"],
        "bench_eval", failures)


def scripts_phase(device, card):
    """Phase 10. Returns (launches_by_path additions per kernel, the
    largest kernel vs plain error)."""
    import PIL

    t10 = time.monotonic()
    found = {m: importlib.util.find_spec(m) is not None
             for m in ("matplotlib", "imageio", "yaml", "tqdm")}
    phase(f"phase 10 [{card}]: this machine's Python {sys.version.split()[0]}"
          f", Pillow {PIL.__version__}, importable: {found}")
    failures = []
    with tempfile.TemporaryDirectory() as workdir:
        city = os.path.join(workdir, "city")
        dense, err, _, fused = cityscapes_demo(device, city, failures)
        precompute_leg(device, workdir, failures)
        dense.update(annotations_leg(device, city, failures))
        shutil.rmtree(city)
        tile = tile_scripts_leg(device, workdir, failures)
        torch.cuda.empty_cache()
        eval_cli_leg(workdir, failures)
    if failures:
        raise AssertionError(f"phase 10: {len(failures)} gates failed: "
                             + "; ".join(failures))
    phase(f"phase 10 took {time.monotonic() - t10:.1f} s")
    return {"raster_dense": dense, "raster_tile": tile, "fusion": fused}, err


# ------------------------------------------------------------------ phase 11
# the port's measuring surface: its bench (python -m
# semantic_meshes_torch.bench, bench.py's CLI and JSON lines) in child
# processes, the driver entry (semantic_meshes_torch.graft_entry) and the
# microbenches (semantic_meshes_torch.scripts.microbench_*) in process at
# their JAX scripts' default sizes
BENCH_TIMEOUT_S = 600
# the presets phase 5 times (and phase 8, e2e), whose times phase 11
# prints beside the bench's
PHASE5_PRESETS = ("large", "scannet", "dense", "texels", "texels01")
MICROBENCHES = ("microbench_scannet", "microbench_dense",
                "microbench_microrows", "microbench_tile_fusion")


def bench_launches(preset):
    """The launches of one bench batch: each view through raster_tile at
    the tile presets, through raster_dense at the dense ones with pairs,
    none at `dense` (all micro)."""
    from semantic_meshes_torch import bench

    if preset == "e2e":
        return {"raster_tile": 0, "raster_dense": bench.E2E["views"]}
    views = bench.PRESETS[preset][1]
    tile = preset in ("small", "default", "large")
    dense = preset in ("scannet", "texels", "texels01")
    return {"raster_tile": views * tile, "raster_dense": views * dense}


def run_bench(args, failures):
    """`python -m semantic_meshes_torch.bench ARGS` on the card: its JSON
    lines (printed here), [] on failure."""
    t = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "semantic_meshes_torch.bench"] + args,
        env=script_env(), cwd=HERE, capture_output=True, text=True,
        timeout=BENCH_TIMEOUT_S)
    label = " ".join(args) or "(default)"
    out = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    print("\n".join(out), flush=True)
    if proc.returncode != 0:
        print(proc.stderr[-3000:], flush=True)
        check(failures, False, f"bench {label}: rc {proc.returncode}",
              "phase 11")
        return []
    phase(f"phase 11: bench {label}: {len(out)} lines "
          f"({time.monotonic() - t:.1f} s); stderr: "
          + " | ".join(proc.stderr.strip().splitlines()[-6:]))
    return [json.loads(ln) for ln in out]


def bench_records(lines, failures):
    """{preset: (MPix/s, seconds_per_batch, overflow, launches)} of the
    default run (headline first, then one line per sub-preset), gating
    the lines' structure."""
    from semantic_meshes_torch import bench

    subs = bench.SUB_PRESETS
    check(failures, len(lines) == 1 + len(subs),
          f"bench: {len(lines)} lines, expected 1 + {len(subs)}", "phase 11")
    if not lines:
        return {}
    head, last = lines[0]["detail"], lines[-1]["detail"]
    check(failures, head["preset"] == "default"
          and "skipped" not in head
          and not any(f"{s}_MPix_s" in head for s in subs),
          "bench: the first line is not the bare headline", "phase 11")
    check(failures, len({ln["value"] for ln in lines}) == 1,
          "bench: the lines' values differ", "phase 11")
    check(failures, last.get("skipped") == [],
          f"bench: skipped {last.get('skipped')}", "phase 11")
    records = {"default": (lines[0]["value"], head["seconds_per_batch"],
                           head["overflow"], head["launches"])}
    for s in subs:
        if f"{s}_MPix_s" in last:
            records[s] = tuple(last[f"{s}_{k}"] for k in (
                "MPix_s", "seconds_per_batch", "overflow", "launches"))
    return records


def graft_check(card):
    """graft_entry.entry() on the card == the same fn on the CPU, and the
    dry run in an NCCL world of one. Returns raster_tile's launches of
    the card's fn."""
    from semantic_meshes_torch import graft_entry

    fn, args = graft_entry.entry()
    out, launches = counted(fn, *args)
    fn_cpu, args_cpu = graft_entry.entry(device="cpu")
    ref = fn_cpu(*args_cpu)
    if tuple(out.shape) != (300, 19) or not torch.allclose(
            out.cpu(), ref, rtol=graft_entry.RTOL, atol=graft_entry.ATOL):
        raise AssertionError(
            f"graft entry: card {tuple(out.shape)} != CPU (max |err| "
            f"{float((out.cpu() - ref).abs().max())})")
    if launches != {"raster_tile": 2, "raster_dense": 0}:
        raise AssertionError(f"graft entry: launches {launches}")
    phase(f"phase 11 [{card}]: graft_entry.entry() on the card == on the "
          f"CPU (rtol {graft_entry.RTOL}, atol {graft_entry.ATOL}; max |err| "
          f"{float((out.cpu() - ref).abs().max()):.3e}), (300, 19), "
          f"launches {launches}")
    graft_dryrun(card, 1)
    return launches["raster_tile"]


def graft_dryrun(card, n):
    """graft_entry.dryrun_multichip(n): n NCCL ranks, one a card."""
    from semantic_meshes_torch import graft_entry

    t = time.monotonic()
    logs = graft_entry.dryrun_multichip(n)
    cases = [ln for ln in logs[0].splitlines() if ln.startswith("rank 0")]
    phase(f"phase 11 [{card}]: dryrun_multichip({n}) ok, an NCCL world of "
          f"{n} ({time.monotonic() - t:.1f} s): " + "; ".join(cases))


def microbenches(card):
    """Every microbench's main in process at its default sizes; their
    launches per kernel (the timing loops' included)."""
    from semantic_meshes_torch.scripts.microbench_segment_sum import PROBES

    paths = {"raster_tile": {}, "raster_dense": {}}
    runs = [(m, []) for m in MICROBENCHES] + [
        ("microbench_segment_sum", ["--probe", p]) for p in PROBES]
    for module, argv in runs:
        mod = importlib.import_module(f"semantic_meshes_torch.scripts."
                                      f"{module}")
        t = time.monotonic()
        _, launches = counted(mod.main, argv)
        torch.cuda.empty_cache()
        label = " ".join([module] + argv)
        phase(f"phase 11 [{card}]: {label} ok ({time.monotonic() - t:.1f} "
              f"s), launches {launches}")
        for kernel, n in launches.items():
            if n:
                paths[kernel][label] = n
    return paths


def bench_phase(device, card, phase5, e2e_ms):
    """Phase 11. phase5: {preset: batch ms} of phase 5 (empty when it did
    not run), e2e_ms: phase 8's e2e_image_time (or None). Returns
    launches_by_path additions per kernel."""
    t11 = time.monotonic()
    torch.cuda.empty_cache()
    failures = []
    records = bench_records(run_bench([], failures), failures)
    for args in (["--preset", "large"], ["--preset", "e2e"]):
        lines = run_bench(args, failures)
        check(failures, len(lines) == 1,
              f"bench {' '.join(args)}: {len(lines)} lines", "phase 11")
        if lines:
            d = lines[0]["detail"]
            records[args[1]] = (lines[0]["value"], d.get(
                "seconds_per_batch"), d["overflow"], d["launches"])
    paths = {"raster_tile": {}, "raster_dense": {}}
    for preset, (value, spb, overflow, launches) in records.items():
        want = bench_launches(preset)
        check(failures, overflow == 0, f"bench {preset}: overflow "
              f"{overflow}", "phase 11")
        check(failures, launches == want, f"bench {preset}: launches "
              f"{launches}, expected {want}", "phase 11")
        for kernel, n in launches.items():
            paths[kernel][f"bench {preset}"] = n
    missing = {"default", "large", "e2e", *PHASE5_PRESETS} - set(records)
    check(failures, not missing, f"bench: no record of {sorted(missing)}",
          "phase 11")
    for preset in PHASE5_PRESETS:
        if preset in records and preset in phase5:
            bench_ms = records[preset][1] * 1e3
            phase(f"phase 11 [{card}]: {preset}: the bench's "
                  f"seconds_per_batch {bench_ms:.6f} ms, phase 5's batch "
                  f"{phase5[preset]:.6f} ms, ratio "
                  f"{bench_ms / phase5[preset]:.6f}")
    if "e2e" in records and e2e_ms is not None:
        phase(f"phase 11 [{card}]: e2e: the bench's e2e_image_time "
              f"{records['e2e'][0]:.6f} ms/image, phase 8's {e2e_ms:.6f}, "
              f"ratio {records['e2e'][0] / e2e_ms:.6f}")
    if not phase5:
        phase("phase 11: phases 5 and 8 did not run in this call: no "
              "ratios against them")
    paths["raster_tile"]["graft entry"] = graft_check(card)
    for kernel, more in microbenches(card).items():
        paths[kernel].update(more)
    if failures:
        raise AssertionError(f"phase 11: {len(failures)} gates failed: "
                             + "; ".join(failures))
    phase(f"phase 11 took {time.monotonic() - t11:.1f} s")
    return paths


# ------------------------------------------------------------------ phase 12
# face, vertex and camera-count bucketing (render._face_bucket): padding
# rows render nothing, but a renderer routes on its padded face count, so
# the cube at s=35 (14700 faces, padded to 16384 = DENSE_THRESHOLD) takes
# raster_dense bucketed, as the JAX package routes it on its accelerator,
# and raster_tile (256 candidates a tile) unbucketed. The eval CLI
# buckets by default (--no_face_buckets turns it off).
BUCKET_SUB = 35
BUCKET_FACES = 14700
BUCKET_ROWS = 16384
BUCKET_TPP = 0.1
# the eval CLI's fake scene (testing.build_synthetic_scannet_scene): the
# s=35 cube, frames at the eval's depth size, clean one-hot predictions
BUCKET_EVAL = dict(num_views=4, width=640, height=480)


def cube_mesh(sub):
    from semantic_meshes_torch import testing

    vertices, faces = testing.make_cube(subdivisions=sub)
    return SimpleNamespace(vertices=vertices, faces=faces)


def render_all(renderer, cams):
    """Every view's (ids (W, H) int32, depth) through renderer.render."""
    return [(i.view(torch.int32), d) for i, d in
            (renderer.render(c) for c in cams)]


def same_renders(name, got, want):
    """Two renders of the same views: ids equal, depths bit-equal."""
    for k, ((ik, zk), (ip, zp)) in enumerate(zip(got, want)):
        assert_same_image(name, k, zk, ik, zp, ip)


def bucketed_small(device, card):
    """The 108-face cube (s=3) on `default`'s views, padded to 1024 rows:
    raster_tile once a view, == the unbucketed renders, == plain on the
    padded rows. Returns (raster_tile launches, the kernel's error)."""
    import semantic_meshes_torch as smt
    from semantic_meshes_torch.rasterize import tile_kernel

    _, _, cams = scene("default")
    mesh = cube_mesh(3)
    plain = smt.render.triangles(mesh, bucket=False, device=device)
    padded = smt.render.triangles(mesh, bucket=True, device=device)
    rows = (padded.faces.shape[0], padded.vertices.shape[0])
    if rows != (1024, 1024) or padded.getPrimitivesNum() != 108:
        raise AssertionError(f"bucketed cube s=3: {rows} rows")
    got, launches = counted(render_all, padded, cams)
    expect_launches("bucketed cube s=3", launches, "raster_tile", len(cams))
    same_renders("bucketed cube s=3", got, render_all(plain, cams))
    err = 0.0
    for k, cam in enumerate(cams):
        args, overflow = view_inputs(padded.face_vertices, cam, device)
        zk, ik = tile_kernel.resolve_tiles_cuda(*args)
        zp, ip = tile_kernel.resolve_tiles_plain(*args)
        torch.cuda.synchronize()
        if int(overflow):
            raise AssertionError(f"bucketed cube s=3 view {k}: overflow")
        err = max(err, assert_same_image("bucketed cube s=3", k, zk, ik, zp,
                                         ip))
    phase(f"phase 12 [{card}]: cube s=3 bucketed (108 faces -> 1024 rows, "
          f"1024 vertex rows) at default ({len(cams)} views of "
          f"{cams[0].resolution[0]}x{cams[0].resolution[1]}): raster_tile "
          f"{launches['raster_tile']} launches, == unbucketed (ids equal, "
          "depths bit-equal), == plain on the padded rows")
    return launches["raster_tile"], err


def bucketed_scannet(device, card):
    """The s=35 cube at `scannet`'s 8 views of 1296x968: bucketed through
    raster_dense (== the unbucketed render forced dense, == plain on every
    view, overflow 0, no id at or past 14700); unbucketed through
    raster_tile, its dropped pairs and valid pixels beside; bucketed
    against unbucketed dense timed in turns. Returns (launches by path,
    the kernel's error)."""
    import semantic_meshes_torch as smt
    from semantic_meshes_torch.rasterize import dense_kernel

    _, _, cams = scene("scannet")
    mesh = cube_mesh(BUCKET_SUB)
    hw = (cams[0].resolution[1], cams[0].resolution[0])
    padded = smt.render.triangles(mesh, bucket=True, device=device)
    if (padded.faces.shape[0] != BUCKET_ROWS
            or padded.getPrimitivesNum() != BUCKET_FACES
            or smt.rasterize.check_backend(BUCKET_ROWS) != "dense"):
        raise AssertionError(f"bucketed s=35: {padded.faces.shape[0]} rows")
    padded.prepare(cams)
    cap = padded.dense_cap_policy._cap[hw]
    got, launches = counted(render_all, padded, cams)
    expect_launches("bucketed s=35", launches, "raster_dense", len(cams))
    if padded.overflow_total():
        raise AssertionError(f"bucketed s=35: overflow "
                             f"{padded.overflow_total()}")
    top = max(int(i.max()) for i, _ in got)
    if top >= BUCKET_FACES:
        raise AssertionError(f"bucketed s=35: id {top} of a padding row")
    dense = smt.render.triangles(mesh, bucket=False, backend="dense",
                                 device=device)
    same_renders("bucketed s=35 vs unbucketed dense", got,
                 render_all(dense, cams))
    err = 0.0
    for k, cam in enumerate(cams):
        args, pargs, overflow = dense_view_pair(
            "bucketed s=35", k, padded.face_vertices, cam, cap, device)
        zk, ik = dense_kernel.resolve_dense_cuda(*args)
        zp, ip = dense_kernel.resolve_dense_plain(*pargs)
        torch.cuda.synchronize()
        if int(overflow):
            raise AssertionError(f"bucketed s=35 view {k}: overflow "
                                 f"{int(overflow)}")
        err = max(err, assert_same_image("bucketed s=35", k, zk, ik, zp, ip))
    tile = smt.render.triangles(mesh, bucket=False, device=device)
    old, tile_launches = counted(render_all, tile, cams)
    expect_launches("unbucketed s=35", tile_launches, "raster_tile",
                    len(cams))
    dropped = tile.overflow_total()
    valid = [int((i >= 0).sum()) for i, _ in got]
    kept = [int((i >= 0).sum()) for i, _ in old]
    differ = sum(int((a[0] != b[0]).sum()) for a, b in zip(old, got))
    ms = render_turns(padded, dense, cams)
    phase(f"phase 12 [{card}]: cube s=35 bucketed ({BUCKET_FACES} faces -> "
          f"{BUCKET_ROWS} rows) at scannet ({len(cams)} views of "
          f"{hw[1]}x{hw[0]}, budget {cap}): raster_dense "
          f"{launches['raster_dense']} launches, overflow 0, == unbucketed "
          "forced dense (ids equal, depths bit-equal), raster_dense == plain "
          f"on every view, largest id {top}; unbucketed (the tile route): "
          f"raster_tile {tile_launches['raster_tile']} launches, {dropped} "
          f"candidate pairs dropped, {sum(kept)} of {sum(valid)} valid pixels "
          f"kept ({sum(kept) / sum(valid):.6f}; per view {kept} of {valid}), "
          f"{differ} pixels differ; render_many launched ms a view, "
          f"bucketed against unbucketed dense: {ms}")
    return ({"raster_dense": {"s=35 bucketed at scannet":
                              launches["raster_dense"]},
             "raster_tile": {"s=35 unbucketed at scannet":
                             tile_launches["raster_tile"]}}, err)


def render_turns(padded, plain, cams, rounds=4):
    """render_many of every view through a bucketed and an unbucketed
    renderer in turns (a b b a, `rounds` times), each turn the median of 5
    (CUDA events around Python launching): the median launched ms a view
    of each, the ratio, and the ratio's range over the rounds."""
    turns = {"bucketed": [], "unbucketed": []}
    for _ in range(rounds):
        for name, r in (("bucketed", padded), ("unbucketed", plain),
                        ("unbucketed", plain), ("bucketed", padded)):
            turns[name].append(cuda_time_ms(lambda: r.render_many(cams), 5)
                               / len(cams))
    ratios = [b / u for b, u in zip(turns["bucketed"], turns["unbucketed"])]
    ms = {k: statistics.median(v) for k, v in turns.items()}
    return {**{k: round(v, 6) for k, v in ms.items()},
            "ratio": round(ms["bucketed"] / ms["unbucketed"], 6),
            "ratio_range": [round(min(ratios), 6), round(max(ratios), 6)]}


def bucketed_eval_scale(device, card):
    """The padding's cost at the eval's own scale: `scannet`'s mesh (cube
    s=91, 99372 faces, padded to 114688 rows) on its 8 views, bucketed
    against unbucketed (both raster_dense), in turns; the renders equal."""
    import semantic_meshes_torch as smt

    vertices, faces, cams = scene("scannet")
    mesh = SimpleNamespace(vertices=vertices, faces=faces)
    padded = smt.render.triangles(mesh, bucket=True, device=device)
    plain = smt.render.triangles(mesh, bucket=False, device=device)
    for r in (padded, plain):
        r.prepare(cams)
    same_renders("bucketed scannet", render_all(padded, cams),
                 render_all(plain, cams))
    ms = render_turns(padded, plain, cams)
    phase(f"phase 12 [{card}]: scannet's mesh bucketed ({len(faces)} faces "
          f"-> {padded.faces.shape[0]} rows) == unbucketed on its "
          f"{len(cams)} views; render_many launched ms a view, bucketed "
          f"against unbucketed: {ms}")


def bucketed_texels(device, card):
    """Texels at BUCKET_TPP a pixel on the s=35 cube at `scannet`'s views:
    bucketed (16384 rows, cameras padded to 16) through raster_dense ==
    unbucketed forced dense. Returns raster_dense's launches."""
    import semantic_meshes_torch as smt

    _, _, cams = scene("scannet")
    mesh = cube_mesh(BUCKET_SUB)
    padded = smt.render.texels(mesh, cams, BUCKET_TPP, bucket=True,
                               device=device)
    dense = smt.render.texels(mesh, cams, BUCKET_TPP, bucket=False,
                              backend="dense", device=device)
    P = dense.getPrimitivesNum()
    res = padded.resolutions
    if (padded.getPrimitivesNum() != P or res.shape[0] != BUCKET_ROWS
            or not torch.equal(res[:BUCKET_FACES], dense.resolutions)
            or bool((res[BUCKET_FACES:] != 0).any())):
        raise AssertionError("bucketed texels: tables differ from the "
                             "unbucketed renderer's")
    padded.prepare(cams)
    got, launches = counted(render_all, padded, cams)
    expect_launches("bucketed s=35 texels", launches, "raster_dense",
                    len(cams))
    same_renders("bucketed s=35 texels", got, render_all(dense, cams))
    if padded.overflow_total():
        raise AssertionError("bucketed s=35 texels: overflow")
    covered = sum(int((i >= 0).sum()) for i, _ in got)
    phase(f"phase 12 [{card}]: texels at {BUCKET_TPP} a pixel on cube s=35 "
          f"bucketed ({P} texels, resolutions of the "
          f"{BUCKET_ROWS - BUCKET_FACES} padding rows 0): raster_dense "
          f"{launches['raster_dense']} "
          f"launches, == unbucketed forced dense on {len(cams)} views "
          f"({covered} texel pixels), overflow 0")
    return launches["raster_dense"]


def eval_cli_fused(root, label, extra, device):
    """eval_scannet's CLI in process on the fake scene under `root`, output
    to root/label, its evaluate_scene results kept: (results,
    launches)."""
    from semantic_meshes_torch import eval_scannet

    results = []
    core = eval_scannet.evaluate_scene

    def keep(*args, **kwargs):
        results.append(core(*args, **kwargs))
        return results[-1]

    argv = ["--scannet", root, "--model", "probs", "--probs_dir",
            os.path.join(root, "probs"), "--aggregator", "sum", "--output",
            os.path.join(root, label), "--device", device] + extra
    eval_scannet.evaluate_scene = keep
    try:
        out, launches = counted(eval_scannet.main, argv)
    finally:
        eval_scannet.evaluate_scene = core
    if out != 0 or len(results) != 1:
        raise AssertionError(f"eval CLI {extra}: rc {out}, "
                             f"{len(results)} scenes")
    return results[0], launches


def bucketed_eval_cli(device, card):
    """The eval CLI at its defaults on a fake ScanNet scene of the s=35
    cube: bucketed, so raster_dense and no raster_tile; the fused colours
    on the card == on the CPU; beside it --no_face_buckets (raster_tile,
    its overflow and the faces whose colour moves). Returns launches by
    path."""
    from semantic_meshes_torch import eval_scannet, testing
    from semantic_meshes_torch.utils import class_palette

    palette = torch.as_tensor(class_palette(eval_scannet.CLASSES))
    with tempfile.TemporaryDirectory() as root:
        testing.write_scannet_label_tsv(
            os.path.join(root, "scannetv2-labels.combined.tsv"))
        os.makedirs(os.path.join(root, "scans"))
        faces, views = testing.build_synthetic_scannet_scene(
            root, "scene0000_00", subdivisions=BUCKET_SUB, device=device,
            **BUCKET_EVAL)
        card_run, launches = eval_cli_fused(root, "card", [], str(device))
        if (launches["raster_dense"] == 0 or launches["raster_tile"] != 0
                or card_run["overflow"] or card_run["primitives"] != faces):
            raise AssertionError(f"eval CLI defaults: launches {launches}, "
                                 f"overflow {card_run['overflow']}")
        cpu_run, _ = eval_cli_fused(root, "cpu", [], "cpu")
        fused, fused_cpu = card_run["fused"].cpu(), cpu_run["fused"]
        colours = palette[fused.argmax(-1)]
        if not torch.equal(colours, palette[fused_cpu.argmax(-1)]):
            raise AssertionError("eval CLI defaults: fused colours card != "
                                 "CPU")
        gap = float((fused - fused_cpu).abs().max())
        if gap > 1e-5 * max(float(fused_cpu.abs().max()), 1.0):
            raise AssertionError(f"eval CLI defaults: fused card vs CPU "
                                 f"max |d| {gap}")
        off, off_launches = eval_cli_fused(
            root, "unbucketed", ["--no_face_buckets"], str(device))
        moved = int((palette[off["fused"].cpu().argmax(-1)] != colours)
                    .any(-1).sum())
    phase(f"phase 12 [{card}]: eval CLI at its defaults on a fake scene "
          f"(cube s={BUCKET_SUB}, {faces} faces, {views} frames of "
          f"{BUCKET_EVAL['width']}x{BUCKET_EVAL['height']}): raster_dense "
          f"{launches['raster_dense']} launches, raster_tile 0, overflow 0, "
          f"fused colours card == CPU (max |d| {gap}); --no_face_buckets: "
          f"raster_tile {off_launches['raster_tile']} launches, overflow "
          f"{off['overflow']}, {moved} of {faces} face colours differ")
    return {"raster_dense": {"eval CLI defaults, s=35":
                             launches["raster_dense"]},
            "raster_tile": {"eval CLI --no_face_buckets, s=35":
                            off_launches["raster_tile"]}}


def bucketing_phase(device, card):
    """Phase 12. Returns (launches_by_path additions per kernel, the
    largest kernel vs plain error of each kernel)."""
    t12 = time.monotonic()
    paths = {"raster_tile": {}, "raster_dense": {}}
    n, tile_err = bucketed_small(device, card)
    paths["raster_tile"]["cube s=3 bucketed at default"] = n
    more, dense_err = bucketed_scannet(device, card)
    for kernel, p in more.items():
        paths[kernel].update(p)
    bucketed_eval_scale(device, card)
    paths["raster_dense"]["s=35 texels 0.1 bucketed at scannet"] = \
        bucketed_texels(device, card)
    for kernel, p in bucketed_eval_cli(device, card).items():
        paths[kernel].update(p)
    phase(f"phase 12 took {time.monotonic() - t12:.1f} s")
    return paths, tile_err, dense_err


def parse_args():
    parser = argparse.ArgumentParser(
        description="Chip smoke run of semantic_meshes_torch on one card.")
    parser.add_argument(
        "--sharded-only", action="store_true",
        help="run phases 1, 2 and 7 only (multi-GPU fusion: bands, face "
             "blocks, the NCCL world of one and, with two or more cards, "
             "one rank per card), for calls on several cards; prints no "
             "kernel line")
    parser.add_argument(
        "--models-only", action="store_true",
        help="run phases 1, 2, 8 and 9 only (the segmentation "
             "predictors: card vs CPU, bench.py's e2e, the ScanNet RGBD "
             "eval, the PSPNet demo; training and the ScanNet eval entry "
             "point); prints no kernel line")
    parser.add_argument(
        "--scripts-only", action="store_true",
        help="run phases 1, 2 and 10 only (the user scripts and the "
             "ScanNet drivers at full width); prints no kernel line")
    parser.add_argument(
        "--bench-only", action="store_true",
        help="run phases 1, 2, 11 and 12 only (the port's bench, its "
             "driver entry and the microbenches; face bucketing); prints no "
             "kernel line")
    parser.add_argument(
        "--against", action="append", default=[], metavar="DIR",
        help="a checkout of an earlier commit (its semantic_meshes_torch/ "
             "at least) whose kernels are timed in turns with this one's; "
             "labelled by the directory's name; repeatable")
    return parser.parse_args()


def main():
    args = parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: torch.cuda.is_available() is False; "
                 "this run needs a CUDA card")
    sys.path.insert(0, HERE)
    try:
        from semantic_meshes_torch import _build
    except ImportError as e:
        sys.exit(f"chip_smoke.py: semantic_meshes_torch not importable "
                 f"beside this script ({e})")
    device = torch.device("cuda", 0)
    t0 = time.monotonic()

    card = card_line()
    phase(f"phase 1: card: {card}")

    against = {}
    for i, path in enumerate(args.against):
        label = os.path.basename(os.path.normpath(path))
        if label in against or label == "current":
            sys.exit(f"chip_smoke.py: two --against directories named "
                     f"{label!r}")
        against[label] = load_against(path, i)
    builds = {"": _build, **{k: a.build for k, a in against.items()}}
    def libraries(label):
        # the fusion library is this checkout's (an --against may lack it)
        return ("raster_tile", "raster_dense") + (() if label else
                                                   ("fusion",))

    with ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda kv: kv[1].build(*libraries(kv[0])),
                      builds.items()))
    for label, build in builds.items():
        for name in libraries(label):
            report = [ln.strip() for ln in build.build_log(name).splitlines()
                      if "ptxas info" in ln and ("Used" in ln
                                                 or "Compiling" in ln)]
            phase(f"phase 2: built {name}{' of ' + label if label else ''}"
                  ": " + " | ".join(report))

    if (args.sharded_only or args.models_only or args.scripts_only
            or args.bench_only):
        if args.sharded_only:
            multi_gpu(device, card)
            if torch.cuda.device_count() >= 2:
                graft_dryrun(card, torch.cuda.device_count())
        if args.models_only:
            models_phase(device, card)
            training_phase(device, card)
        if args.scripts_only:
            scripts_phase(device, card)
        if args.bench_only:
            bench_phase(device, card, {}, None)
            bucketing_phase(device, card)
        raise_prep_faults()
        phase(f"done in {time.monotonic() - t0:.1f} s")
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}), flush=True)
        return

    tile_err = tile_vs_plain(device)
    dense_err = max(dense_vs_plain(device), texel_dense_vs_plain(device))
    clip_err = clipped_vs_plain(device)
    tile_err, dense_err = max(tile_err, clip_err), max(dense_err, clip_err)

    with tempfile.TemporaryDirectory() as workdir:
        large = main_path("large", device, workdir)
        scannet = main_path("scannet", device, workdir)
        texel_setup_check(device)
        texels = {name: texel_main_path(name, device, workdir)
                  for name in ("texels", "texels01")}
        scannet_lens = distorted_scannet(device, workdir)
    default_texels = texel_tile_check(device)
    dense_ctx = dense_preset(device)
    large_lens = distorted_large(device)
    texel_lens = distorted_texels(device)
    grid_card_vs_cpu(device, card)
    with tempfile.TemporaryDirectory() as workdir:
        indoor = {name: indoor_main_path(name, device, workdir)
                  for name in ("scannet", "large")}
    indoor["texels01"] = indoor_texels01(device)
    indoor_lens = indoor_scannet_lens(device)

    tile_times("default", device, card, against)
    tile_row = tile_times("large", device, card, against)
    dense_row = dense_times(scannet, device, card, against)
    prep_row = dense_prep_row(scannet, device, card)
    fusion_rows = fusion_row(device, card)
    dense_kernel_row("default forced dense",
                     [v[0] for v in dense_inputs("default", device,
                                                 "dense")[1]],
                     against, card)
    large_times(large, device, card)
    phase5 = {name: batch_throughput(name, ctx, device, card)
              for name, ctx in (("large", large), ("scannet", scannet))}
    by_path = {
        "raster_tile": {"large": large["launches"],
                        "default texels": default_texels["raster_tile"]},
        "raster_dense": {"scannet": scannet["launches"],
                         "dense": dense_ctx["launches"]["raster_dense"]},
        "dense_prep": {"scannet": scannet["prep_launches"],
                       "dense": dense_ctx["prep_launches"]},
        "fusion": {"scannet": scannet["fusion_launches"],
                   "large": large["fusion_launches"],
                   "dense": dense_ctx["fusion_launches"]}}
    for name, ctx in texels.items():
        for kernel, n in ctx["launches"].items():
            by_path[kernel][name] = n
        by_path["dense_prep"][name] = ctx["prep_launches"]
        by_path["fusion"][name] = ctx["fusion_launches"]
    by_path["raster_dense"]["scannet + SIMPLE_RADIAL"] = \
        scannet_lens["launches"]["raster_dense"]
    by_path["raster_tile"]["large + lenses"] = \
        large_lens["launches"]["raster_tile"]
    by_path["raster_tile"]["default texels + lenses"] = \
        texel_lens["tile"]["launches"]["raster_tile"]
    by_path["raster_dense"]["default texels + lenses, forced dense"] = \
        texel_lens["dense"]["launches"]["raster_dense"]
    for name, ctx in indoor.items():
        kernel = "raster_tile" if name == "large" else "raster_dense"
        by_path[kernel][f"{name} indoor + clip"] = ctx["launches"][kernel]
    by_path["dense_prep"]["scannet indoor + clip"] = \
        indoor["scannet"]["prep_launches"]
    by_path["raster_dense"]["scannet indoor + clip + SIMPLE_RADIAL"] = \
        indoor_lens["launches"]["raster_dense"]
    del large, scannet
    phase5["dense"] = batch_throughput("dense", dense_ctx, device, card)
    del dense_ctx
    for name, ctx in texels.items():
        texel_times(name, ctx, device, card)
        phase5[name] = batch_throughput(name, ctx, device, card)
    del texels
    lens_times(large_lens, scannet_lens, device, card)
    batch_throughput("scannet", scannet_lens, device, card,
                     "scannet + SIMPLE_RADIAL")
    batches_in_turns("scannet", scannet_lens["pinhole_batch"],
                     "scannet + SIMPLE_RADIAL", scannet_lens["batch"], card)
    batch_throughput("large", large_lens, device, card, "large + lenses")
    batch_throughput("default", texel_lens["tile"], device, card,
                     "default texels + lenses")
    del scannet_lens, large_lens, texel_lens
    for name, ctx in indoor.items():
        batch_throughput(name, ctx, device, card, f"{name} indoor + clip")
    batches_in_turns("scannet indoor, culled", indoor["scannet"]["cull_batch"],
                     "scannet indoor + clip", indoor["scannet"]["batch"],
                     card)
    clip_times(indoor["scannet"], device, card)
    tile_indoor = tile_times("large", device, card, against, clip=True)
    ctx = indoor["scannet"]
    fv = face_vertices(ctx["vertices"], ctx["faces"], device)
    dense_indoor = dense_kernel_row(
        "scannet indoor + clip",
        [dense_view_inputs(fv, cam, ctx["plan"].dense_e_cap, device,
                           clip_near=True)[0] for cam in ctx["cams"]],
        against, card)
    del indoor, ctx, fv

    by_path["raster_dense"]["scannet eval"], by_path["fusion"][
        "scannet eval"] = scannet_eval(device, card)
    band_tile_err, band_dense_err, sharded = multi_gpu(device, card)
    tile_err, dense_err = max(tile_err, band_tile_err), max(dense_err,
                                                            band_dense_err)
    for kernel, paths in sharded.items():
        by_path[kernel].update(paths)
    model_paths, e2e_ms = models_phase(device, card)
    for kernel, paths in model_paths.items():
        by_path[kernel].update(paths)
    for kernel, paths in training_phase(device, card).items():
        by_path[kernel].update(paths)
    script_paths, script_err = scripts_phase(device, card)
    for kernel, paths in script_paths.items():
        by_path[kernel].update(paths)
    dense_err = max(dense_err, script_err)
    for kernel, paths in bench_phase(device, card, phase5, e2e_ms).items():
        by_path[kernel].update(paths)
    bucket_paths, bucket_tile_err, bucket_dense_err = bucketing_phase(
        device, card)
    for kernel, paths in bucket_paths.items():
        by_path[kernel].update(paths)
    tile_err = max(tile_err, bucket_tile_err)
    dense_err = max(dense_err, bucket_dense_err)

    def indoor_row(path, row):
        keys = ("ms", "launched_ms", "plain_ms", "bound_ms", "bound_by",
                "heaviest_tile_ms", "culled_share")
        return {"indoor": {"path": path,
                           **{k: row[k] for k in keys if k in row}}}

    kernels = [{
        "name": "raster_tile",
        "route": "cuda",
        "source": "semantic_meshes_torch/csrc/raster_tile.cu",
        "replaces": "semantic_meshes/rasterize/pallas_kernel.py:92",
        "launches": by_path["raster_tile"]["large"],
        "launches_by_path": by_path["raster_tile"],
        "max_abs_err": tile_err,
        **tile_row,
        # no single PyTorch call rasterizes triangles
        "library_ms": None,
        **indoor_row("large indoor + clip", tile_indoor),
    }, {
        "name": "raster_dense",
        "route": "cuda",
        "source": "semantic_meshes_torch/csrc/raster_dense.cu",
        "replaces": "semantic_meshes/rasterize/dense.py:530",
        "launches": by_path["raster_dense"]["scannet"],
        "launches_by_path": by_path["raster_dense"],
        "max_abs_err": dense_err,
        **dense_row,
        "library_ms": None,
        **indoor_row("scannet indoor + clip", dense_indoor),
    }, {
        "name": "dense_prep",
        "route": "cuda",
        "source": "semantic_meshes_torch/csrc/dense_prep.cu",
        # XLA ops there (setup, classification, sort binning, scatters of
        # the micro path), no TPU kernel
        "replaces": "semantic_meshes/rasterize/dense.py",
        "launches": by_path["dense_prep"]["scannet"],
        "launches_by_path": by_path["dense_prep"],
        # table, sorted ids, starts, overflow and micro keys bit-equal to
        # the plain chain (dense_view_pair)
        "max_abs_err": 0.0,
        **prep_row,
        "library_ms": None,
    }, {
        "name": "fusion",
        "route": "cuda",
        "source": "semantic_meshes_torch/csrc/fusion.cu",
        # XLA's segment sum there (semantic_meshes/ops.py::segment_sum),
        # no TPU kernel
        "replaces": "semantic_meshes/ops.py",
        # rows inside one chunk bit-equal to the plain chain, the others
        # within rtol 1e-5 (fusion_row)
        "max_abs_err": max(r["max_abs_err"] for r in fusion_rows.values()),
        **fusion_rows["scannet-eval"],
        "by_shape": fusion_rows,
        "launches": by_path["fusion"]["scannet"],
        "launches_by_path": by_path["fusion"],
        "library_ms": None,
    }]
    raise_prep_faults()
    phase(f"done in {time.monotonic() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
