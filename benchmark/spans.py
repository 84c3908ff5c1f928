"""The program's spans in a `torch.profiler` trace: what each layer of
semantic_meshes_torch launched, the device time of that work, the host's
waits and the host's own time.

While a profiler runs the program opens `smt.*` ranges
(`semantic_meshes_torch.profiling.span`): the top spans `smt.render`,
`smt.add` and `smt.fuse_views`, and inside them the layer spans
`smt.dense_prep`, `smt.texel_shader` and `smt.fusion`. Within the traced
batches (`tracing.SPAN`):
- a device event (kernel, memcpy, memset) belongs to a span when the CUDA
  API call that launched it (`cuda*` or `cu*`), joined by
  `args.correlation`, lies inside one of the span's ranges, at any depth;
- a host wait is a stream, device or event synchronize inside any `smt.*`
  range; the harness's own calls, outside every `smt.*` range (its final
  synchronize), are not the program's;
- a span's self time is its ranges' host time less that of the `smt.*`
  ranges directly inside them.
The profiler slows the host, so host times read high; counts and device
times do not depend on it.

    python3 -m benchmark.spans --workload <cell> --seed <n>

makes one traced run of a cell, as `benchmark.run --trace 1` does, keeps
the trace's events and prints one JSON line: the span metrics
(`metrics`; the set-up spans' are in the run's own line, `result`), the
host waits by span and host op, the idle gaps summed by the innermost
span open at their middle (`idle_s_by_span`) and each span's host self
ms a view. It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
from contextlib import contextmanager

from . import tracing

PREFIX = "smt."
LAYERS = {"dense_prep": "smt.dense_prep", "texel_shader": "smt.texel_shader",
          "fusion": "smt.fusion"}
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")
NO_SPAN = "no span"


def _x(e, cats):
    return e.get("ph") == "X" and e.get("cat") in cats


class Spans:
    """The `smt.*` attribution of one trace's events; times in
    microseconds, as the trace gives them."""

    def __init__(self, events):
        self.summary = tracing.TraceSummary(events)
        lo, hi = self.summary.start, self.summary.end
        # by start, a range before those it holds
        self.ranges = sorted(
            ((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"],
              e.get("tid")) for e in events
             if _x(e, ("user_annotation",))
             and str(e.get("name", "")).startswith(PREFIX)
             and lo <= float(e["ts"]) <= hi),
            key=lambda r: (r[0], -r[1]))
        calls = sorted(
            (float(e["ts"]), float(e.get("dur", 0.0)), str(e["name"]),
             e.get("tid"), e.get("args", {}).get("correlation"))
            for e in events if _x(e, tracing.HOST_CATS)
            and lo <= float(e["ts"]) <= hi)
        ops = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                      e["name"], e.get("tid")) for e in events
                     if _x(e, ("cpu_op",)) and lo <= float(e["ts"]) <= hi)
        device = {}
        for e in events:
            c = e.get("args", {}).get("correlation")
            if _x(e, tracing.DEVICE_CATS) and c is not None:
                device[c] = device.get(c, 0.0) + float(e.get("dur", 0.0))
        self.launches, self.device_us = {}, {}
        self.waits, self.wait_us = 0, 0.0
        self.waits_by_op = {}
        for (t, dur, name, tid, corr), open_ in zip(
                calls, self._open_at([(c[0], c[3]) for c in calls])):
            if not open_:
                continue
            if name.startswith(SYNCS):
                self.waits += 1
                self.wait_us += dur
                key = f"{open_[-1]} > {_innermost(ops, t, tid)}"
                n, us = self.waits_by_op.get(key, (0, 0.0))
                self.waits_by_op[key] = (n + 1, us + dur)
            if not name.startswith(tracing.LAUNCH_PREFIXES):
                continue
            for span in set(open_):
                self.launches[span] = self.launches.get(span, 0) + 1
                self.device_us[span] = (self.device_us.get(span, 0.0)
                                        + device.get(corr, 0.0))
        self.self_us, self.top_us = self._self_times()

    def _open_at(self, points):
        """For each (t, tid) point, in order of t: the names of the
        `smt.*` ranges of that thread open at t, outermost first. A
        thread's ranges nest, so one stack a thread sweeps them."""
        starts = {}
        for r in self.ranges:
            starts.setdefault(r[3], []).append(r)
        stacks = {tid: [] for tid in starts}
        nxt = {tid: 0 for tid in starts}
        out = []
        for t, tid in points:
            rs = starts.get(tid, [])
            stack = stacks.get(tid, [])
            while nxt.get(tid, 0) < len(rs) and rs[nxt[tid]][0] <= t:
                r = rs[nxt[tid]]
                while stack and stack[-1][1] < r[0]:
                    stack.pop()
                stack.append(r)
                nxt[tid] += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            out.append([r[2] for r in stack if r[1] >= t])
        return out

    def _self_times(self):
        """({name: self us}, host us of the ranges inside no other)."""
        self_us, top_us = {}, 0.0
        stacks = {}
        for a, b, name, tid in self.ranges:
            stack = stacks.setdefault(tid, [])
            while stack and stack[-1][1] < b:
                stack.pop()
            if stack:
                parent = stack[-1][0]
                self_us[parent] = self_us.get(parent, 0.0) - (b - a)
            else:
                top_us += b - a
            self_us[name] = self_us.get(name, 0.0) + (b - a)
            stack.append((name, b))
        return self_us, top_us

    def idle_by_span(self):
        """Seconds of the idle gaps of the traced batches, summed by the
        innermost `smt.*` range open at each gap's middle."""
        out = {}
        for a, b in self.summary.gaps():
            mid = (a + b) / 2
            inner = [r for r in self.ranges if r[0] <= mid <= r[1]]
            label = min(inner, key=lambda r: r[1] - r[0])[2] if inner \
                else NO_SPAN
            out[label] = out.get(label, 0.0) + (b - a) / 1e6
        return out


def _innermost(ops, t, tid):
    """The name of the innermost host op of thread `tid` running at t
    (ops sorted by start), or "no host op"."""
    i = bisect.bisect_right(ops, (t, float("inf")))
    while i > 0:
        i -= 1
        a, b, name, op_tid = ops[i]
        if op_tid == tid and b >= t:
            return name
        if t - a > 1e6:  # no op of a frame runs a second
            break
    return "no host op"


def fusion_bytes(width, height, classes, primitives):
    """Bytes the fusion of one view needs at least: the float32
    probabilities and the int32 ids of every pixel read once, and the
    view's float32 (P, C) delta written once."""
    return width * height * (classes + 1) * 4 + primitives * classes * 4


def metrics(spans, views, width, height, classes, primitives):
    """The span metrics of a trace of `views` views; a layer that opened
    no range reads nothing."""
    from .metrics._roofline import HBM_BYTES_PER_S

    out = {}
    if not spans.ranges or views <= 0:
        return out
    for layer, name in LAYERS.items():
        if name not in spans.launches:
            continue
        out[f"{layer}.device_ms_per_view"] = \
            spans.device_us[name] / 1e3 / views
        out[f"{layer}.launches_per_view"] = spans.launches[name] / views
    fusion_ms = out.get("fusion.device_ms_per_view")
    if fusion_ms:
        least_s = fusion_bytes(width, height, classes,
                               primitives) / HBM_BYTES_PER_S
        out["fusion.roofline_pct"] = 100.0 * least_s / (fusion_ms / 1e3)
    out["pipeline.host_waits_per_view"] = spans.waits / views
    out["pipeline.host_wait_ms_per_view"] = spans.wait_us / 1e3 / views
    out["pipeline.host_self_ms_per_view"] = \
        (spans.top_us - spans.wait_us) / 1e3 / views
    return out


def setup_s(name):
    """Host seconds the program's set-up span `name` took in this
    process (`semantic_meshes_torch.profiling.timings`), or None: the
    span did not run, or the program has no such timers."""
    from semantic_meshes_torch import profiling

    timings = getattr(profiling, "timings", None)
    entry = timings().get(name) if timings is not None else None
    return None if entry is None else entry["total_s"]


@contextmanager
def keeping_events(kept):
    """While open, `tracing.load` also appends the trace's raw events to
    `kept`."""
    load = tracing.load

    def keep(path):
        with open(path) as f:
            trace = json.load(f)
        events = trace["traceEvents"] if isinstance(trace, dict) else trace
        kept.append(events)
        return tracing.TraceSummary(events)

    tracing.load = keep
    try:
        yield kept
    finally:
        tracing.load = load


def collect(workload, seed, device="cuda", **overrides):
    """One traced run of the cell: the dict that `main` prints."""
    from . import harness

    programs, kept = [], []
    with keeping_events(kept):
        result, _ = harness.run_cell(workload, seed, 0.0, True,
                                     device=device,
                                     program_hook=programs.append,
                                     **overrides)
    program = programs[0]
    views = int(program.traffic["trace_batches"]) * program.views
    s = Spans(kept[0])
    return {"workload": workload, "seed": seed, "views": views,
            "metrics": metrics(s, views, program.width, program.height,
                               int(program.config["classes"]),
                               program.num_primitives),
            "busy_ms_per_view": s.summary.busy_us / 1e3 / views,
            "launches_per_view": s.summary.launches / views,
            "idle_s_by_span": s.idle_by_span(),
            "host_waits_by_op_per_view": {
                k: [n / views, us / 1e3 / views]
                for k, (n, us) in sorted(s.waits_by_op.items())},
            "self_ms_per_view": {k: v / 1e3 / views
                                 for k, v in sorted(s.self_us.items())},
            "result": result}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("benchmark.spans: no CUDA card", file=sys.stderr)
        sys.exit(2)
    print(json.dumps(collect(args.workload, args.seed)), flush=True)


if __name__ == "__main__":
    main()
