"""One run of one cell: set-up, the measured or traced window, the check.

The window is a closed loop of one client, batch after batch through
the program's public entry, as the configuration's source drives it
(traffic `entry`):
- "per_view", the ScanNet eval's loop: one frame a batch through
  `TrianglesRenderer.render` (or `TexelsRenderer.render`) and
  `MeshAggregator.add`, the renderer made with face bucketing and
  `prepare`d over every frame in set-up;
- "chunked", the Cityscapes demo's loop: `views_per_batch` frames a
  batch through `distributed.fuse_views_planned` over one
  `distributed.plan_fuse` of every frame, each batch's accumulator merged
  into the aggregator.
Batch b fuses trajectory frames (b V + j) mod frames with pool slots
(b V + j) mod pool_frames, j < V. Nothing synchronizes a batch: the
dropped pairs are summed once the window has closed, as both sources do,
and the window ends with a synchronize.

A sample of the window's batches, drawn from the seed, is kept (each
batch's own accumulator, copied into buffers made in set-up) and judged
against the reference once the window has closed (reference/check.py).
"""

from __future__ import annotations

import ctypes
import os
import sys
import tempfile
import time
from contextlib import contextmanager
from types import SimpleNamespace

import numpy as np
import torch

from . import scene, spec, tracing
from .reference import check

ENTRIES = ("per_view", "chunked")


def log(*parts):
    print("#", *parts, file=sys.stderr, flush=True)


class Program:
    """The system under test at one cell: the renderer, the aggregator
    and, for "chunked", the plan; `step(b, keep)` runs batch b."""

    def __init__(self, config, traffic, vertices, faces, cams, pool, device):
        from semantic_meshes_torch import distributed, fusion, render
        from semantic_meshes_torch.data import Camera

        self.distributed = distributed
        self.entry = traffic["entry"]
        self.views = int(traffic["views_per_batch"])
        self.frames = int(config["frames"])
        self.pool_frames = int(config["pool_frames"])
        self.height, self.width = int(config["height"]), int(config["width"])
        texel_mode = traffic["mode"] == "texels"
        if self.entry not in ENTRIES:
            raise ValueError(f"traffic entry {self.entry!r} is not one of "
                             f"{ENTRIES}")
        if traffic["loop"] != "closed" or int(traffic["clients"]) != 1:
            raise ValueError("the harness drives a closed loop of one "
                             "client")
        if self.entry == "per_view" and self.views != 1:
            raise ValueError("the per_view entry fuses one frame a batch")
        if self.entry == "chunked" and texel_mode:
            raise ValueError("the chunked entry fuses triangles")
        if self.frames % self.views or self.pool_frames % self.views:
            raise ValueError("frames and pool_frames must be multiples of "
                             "views_per_batch: a batch's frames are a slice")
        self.pool = pool
        self.host = [np.asarray(a) for a in cams]
        self.cameras = [Camera(r, t, (self.width, self.height), f, c)
                        for r, t, f, c in zip(*self.host)]
        self.config, self.traffic = config, traffic
        # what the reference is handed: the same mesh, cameras and pool
        self.scene = (torch.as_tensor(vertices, device=device),
                      torch.as_tensor(faces, device=device),
                      [torch.as_tensor(a, device=device) for a in self.host],
                      pool)
        mesh = _ply(vertices, faces)
        if self.entry == "per_view":
            if texel_mode:
                self.renderer = render.texels(
                    mesh, self.cameras, float(traffic["texels_per_pixel"]),
                    bucket=True, device=device)
            else:
                self.renderer = render.triangles(mesh, bucket=True,
                                                 device=device)
            self.renderer.prepare(self.cameras)
        else:
            self.renderer = render.triangles(mesh, device=device)
            self.plan = distributed.plan_fuse(
                self.renderer.vertices, self.renderer.faces, *self.host,
                height=self.height, width=self.width, device=device)
            self.overflows = []
        self.num_primitives = self.renderer.getPrimitivesNum()
        self.aggregator = fusion.MeshAggregator(
            self.num_primitives, int(config["classes"]),
            aggregator=config["aggregator"],
            images_equal_weight=float(config["images_equal_weight"]),
            device=device)

    def kernel_library(self):
        """The name of the z-resolve library this cell's route loads."""
        from semantic_meshes_torch import rasterize

        dense = rasterize.uses_dense(None, int(self.renderer.faces.shape[0]))
        return "raster_dense" if dense else "raster_tile"

    def step(self, b, keep=False):
        """Batch b through the program; with `keep`, the batch's own
        accumulator (what it added to the aggregator), else None."""
        agg = self.aggregator
        if self.entry == "per_view":
            ids = self.renderer.render(self.cameras[b % self.frames])[0]
            probs = self.pool[b % self.pool_frames].transpose(0, 1)
            if not keep:
                agg.add(ids, probs)
                return None
            # add onto zeros, then merge: the aggregator ends with the
            # same sum, bit for bit, and the view's delta is kept
            before = agg.state
            agg.state = torch.zeros_like(before)
            agg.add(ids, probs)
            delta = agg.state
            agg.state = before + delta
            return delta
        s = (b * self.views) % self.frames
        k = (b * self.views) % self.pool_frames
        acc, overflow = self.distributed.fuse_views_planned(
            self.plan, self.renderer.vertices,
            *(a[s:s + self.views] for a in self.host),
            self.pool[k:k + self.views], agg.images_equal_weight, None,
            num_primitives=self.num_primitives, aggregator=agg.aggregator,
            height=self.height, width=self.width,
            max_tris_per_tile=self.renderer.max_tris_per_tile,
            device=self.pool.device)
        agg.merge(acc)
        self.overflows.append(overflow)
        return acc if keep else None

    def overflow(self):
        """Dropped pairs or micro rows over every batch so far (one
        synchronize)."""
        if self.entry == "per_view":
            return self.renderer.overflow_total()
        return int(torch.stack(self.overflows).sum()) if self.overflows \
            else 0


def _ply(vertices, faces):
    """The mesh as the sources load it: a PLY file read by data.Ply."""
    from semantic_meshes_torch.data import Ply
    from semantic_meshes_torch.io.ply import write_mesh

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mesh.ply")
        write_mesh(path, vertices, faces)
        return Ply(path)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextmanager
def pinned(device):
    """On a card, keep the launching thread on the CPU it runs on for
    the window: the window is bound by the host's launches, and a thread
    that the scheduler moves between cores ran up to 1.36x faster or
    slower from run to run (PERF.md section 6). The CPU is the one the
    thread already runs on, not a fixed one, and the thread's own set of
    CPUs comes back once the window has closed."""
    cpus = os.sched_getaffinity(0)
    cpu = None
    if device.type == "cuda":
        try:
            cpu = ctypes.CDLL(None, use_errno=True).sched_getcpu()
        except (OSError, AttributeError):
            cpu = None
    if cpu is not None and cpu >= 0 and cpu in cpus:
        os.sched_setaffinity(0, {cpu})
    try:
        yield
    finally:
        os.sched_setaffinity(0, cpus)


class Sample:
    """A reservoir of `n` batch accumulators drawn from the seed (Vitter's
    algorithm R), copied into buffers made in set-up. `slot()` decides
    before a batch runs whether it is kept."""

    def __init__(self, n, shape, seed, device):
        self.rng = np.random.default_rng([abs(int(seed)), 1])
        self.buf = torch.zeros((n,) + shape, dtype=torch.float32,
                               device=device)
        self.batch = [-1] * n
        self.seen = 0

    def slot(self):
        """The slot of the next batch, or None where it is not kept."""
        n = len(self.batch)
        slot = self.seen if self.seen < n else int(
            self.rng.integers(0, self.seen + 1))
        self.seen += 1
        return slot if slot < n else None

    def keep(self, slot, b, acc):
        self.buf[slot].copy_(acc)
        self.batch[slot] = b

    def items(self):
        return [(b, self.buf[i]) for i, b in enumerate(self.batch) if b >= 0]


def build_kernels(program, device):
    """Build or load the cell's z-resolve library, as the demo's "build
    kernels" phase does: {library, built (nvcc ran in this run), seconds}.
    A checkout's first run builds; every later run finds the library."""
    if device.type != "cuda":
        return None
    from semantic_meshes_torch import _build

    name = program.kernel_library()
    built = not _build.library_path(name).exists()
    t = time.monotonic()
    _build.build(name)
    _build.load(name)
    return {"library": name, "built": built,
            "seconds": time.monotonic() - t}


def run_cell(workload, seed, seconds, trace, *, device="cuda", t0=None,
             config_overrides=None, traffic_overrides=None,
             program_hook=None):
    """One run: the result dict of the cell (see run.py). `program_hook`,
    if given, is called with the Program after set-up (tests plant faults
    with it)."""
    t0 = time.monotonic() if t0 is None else t0
    device = torch.device(device)
    bench = spec.load()
    cell = spec.cell(bench, workload)
    config = dict(spec.config(bench, cell["config"]),
                  **(config_overrides or {}))
    traffic = dict(spec.traffic(cell["traffic"]),
                   **(traffic_overrides or {}))
    views = int(traffic["views_per_batch"])

    def stamp(what):
        log(f"{time.monotonic() - t0:.3f} s: {what}")

    stamp("imports")
    vertices, faces = scene.make_cube(config["subdivisions"],
                                      config["mesh_size"])
    cams = scene.trajectory(config, seed)
    pool = scene.probability_pool(config, seed, device)
    _sync(device)
    stamp("mesh, trajectory, probability pool")
    program = Program(config, traffic, vertices, faces, cams, pool, device)
    build = build_kernels(program, device)
    if program_hook is not None:
        program_hook(program)
    P, C = program.num_primitives, int(config["classes"])
    _sync(device)
    stamp(f"{workload}: {len(faces)} faces, {P} primitives, "
          f"{config['frames']} frames of {config['width']}x"
          f"{config['height']}x{C}, entry {program.entry}, "
          f"{views} views a batch; kernels {build}")

    from semantic_meshes_torch.rasterize import dense_kernel, tile_kernel

    b = 0
    warmup = int(traffic["warmup_batches"])
    for i in range(warmup):
        tile_kernel.launches = dense_kernel.launches = 0
        program.step(b, keep=i == warmup - 1)
        b += 1
    stamp(f"warm-up; route: raster_tile {tile_kernel.launches}, "
          f"raster_dense {dense_kernel.launches} launches in the last "
          f"warm-up batch")
    sample = Sample(int(traffic["check_batches"]), (P, C), seed, device)
    _sync(device)

    failed, attempted = 0, 0
    summary, traced_views = None, 0
    setup_s = time.monotonic() - t0

    def one_batch():
        nonlocal failed, attempted, b
        attempted += 1
        slot = sample.slot()
        try:
            acc = program.step(b, keep=slot is not None)
            if acc is not None:
                sample.keep(slot, b, acc)
        except Exception as e:  # noqa: BLE001 -- a batch that raises fails
            log(f"batch {b} raised {e!r}")
            failed += 1
        b += 1

    with pinned(device):
        start = time.perf_counter()
        if not trace:
            while True:
                one_batch()
                if time.perf_counter() - start >= seconds:
                    break
            _sync(device)
            wall = time.perf_counter() - start
        else:
            n = int(traffic["trace_batches"])
            summary, wall = _traced(one_batch, n, device)
            traced_views = n * views
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    overflow = program.overflow()

    # the program's state goes before the reference runs
    kept = sample.items()
    handed = program.scene
    del program
    if device.type == "cuda":
        torch.cuda.empty_cache()
    tc = time.monotonic()
    ref = check.BatchReference(*handed, config=config, traffic=traffic)
    gap = max((check.row_gap(acc, *ref.batch(kb)) for kb, acc in kept),
              default=float("inf"))
    numbers = {"row_gap": gap, "overflow": overflow, "failed": failed,
               "primitives": abs(P - ref.num_primitives)}
    correct, rows = check.judge(numbers)
    log(f"checked {len(kept)} batches of {attempted} in "
        f"{time.monotonic() - tc:.1f} s; texel sizing ambiguous on "
        f"{ref.ambiguous_sizing} triangles")

    frame_pixels = int(config["width"]) * int(config["height"])
    ctx = SimpleNamespace(
        window=None if trace else {
            "completed": attempted - failed, "wall_s": wall,
            "pixels_per_batch": views * frame_pixels},
        setup_s=setup_s, trace=summary, traced_views=traced_views,
        width=int(config["width"]), height=int(config["height"]),
        vertices=len(vertices), faces=len(faces))
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec.metrics_of(bench, workload, kind):
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = device_info(device, memory_peak)
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_us / 1e6
        dev["window_s"] = summary.window_us / 1e6
        result["breakdown"] = {"device_ops": summary.top_device_ops(),
                               "idle_gaps": summary.idle_gaps()}
    result["build"] = build
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in rows}
    return result, rows


def _traced(one_batch, n, device):
    """n batches under torch.profiler, after two that warm the profiler
    up, in `tracing.SPAN` ranges; the device is synchronized before the
    first and at the end of the last, so that the span holds the traced
    batches' device work and no other: (TraceSummary, wall s of the
    traced batches)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from torch.profiler import schedule

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        with profile(activities=activities,
                     schedule=schedule(wait=0, warmup=2, active=n),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)
                     ) as prof:
            for _ in range(2):
                one_batch()
                prof.step()
            _sync(device)
            start = time.perf_counter()
            for i in range(n):
                with record_function(tracing.SPAN):
                    one_batch()
                    if i == n - 1:
                        _sync(device)
                prof.step()
            wall = time.perf_counter() - start
        return tracing.load(path), wall
    finally:
        os.remove(path)


def device_info(device, memory_peak):
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(memory_peak),
            "power_limit": power_limit(device)}


def power_limit(device):
    """The card's power limit as nvidia-smi reports it, or None."""
    import subprocess

    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", "-i", str(index)],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip()
