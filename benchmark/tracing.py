"""Reduction of a `torch.profiler` Chrome trace to what the per-layer
metrics read.

The traced span is the union of the host ranges named SPAN (one per
traced batch, `torch.profiler.record_function`). Within it:
- device busy time: the union of the device's kernel, memcpy and memset
  intervals (overlapping streams count once), clipped to the span;
- launches: the host's CUDA runtime and driver calls that put work on the
  device (kernel launches, memcpy and memset calls, graph launches);
- per kernel: the summed device time and the count of its intervals;
- idle gaps: the holes of the busy union inside the span, each labelled
  with the innermost host op that was running at its middle.
"""

from __future__ import annotations

import json
import re

SPAN = "bench.batch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")
LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cuMemcpy",
                   "cudaMemset", "cuMemset", "cudaGraphLaunch",
                   "cuGraphLaunch")


def union(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class TraceSummary:
    """Times in microseconds, as the trace gives them."""

    def __init__(self, events):
        spans = [e for e in events if e.get("ph") == "X"
                 and e.get("cat") == "user_annotation"
                 and e.get("name") == SPAN]
        self.batches = len(spans)
        if not spans:
            self.start = self.end = 0.0
        else:
            self.start = min(float(e["ts"]) for e in spans)
            self.end = max(float(e["ts"]) + float(e["dur"]) for e in spans)
        self.window_us = self.end - self.start
        inside = []
        self.kernels = {}
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
                continue
            a = float(e["ts"])
            b = a + float(e.get("dur", 0.0))
            if b <= self.start or a >= self.end:
                continue
            inside.append((max(a, self.start), min(b, self.end)))
            tot, n = self.kernels.get(e["name"], (0.0, 0))
            self.kernels[e["name"]] = (tot + b - a, n + 1)
        self.busy = union(inside)
        self.busy_us = sum(b - a for a, b in self.busy)
        self.launches = sum(
            1 for e in events if e.get("ph") == "X"
            and e.get("cat") in HOST_CATS
            and str(e.get("name", "")).startswith(LAUNCH_PREFIXES)
            and self.start <= float(e["ts"]) <= self.end)
        self._host_ops = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                           e["name"]) for e in events
                          if e.get("ph") == "X" and e.get("cat") == "cpu_op"
                          and float(e["ts"]) < self.end
                          and float(e["ts"]) + float(e["dur"]) > self.start]

    def idle_share(self):
        """1 - busy / span, or None without a span or device work."""
        if self.window_us <= 0 or self.busy_us <= 0:
            return None
        return 1.0 - self.busy_us / self.window_us

    def kernel(self, name):
        """(summed device us, intervals) of the kernels called `name`: a
        demangled name may carry a namespace before it and its template
        or argument list after it."""
        pattern = re.compile(r"(^|::)" + re.escape(name) + r"(\(|<|$)")
        tot, n = 0.0, 0
        for k, (t, c) in self.kernels.items():
            if pattern.search(k):
                tot, n = tot + t, n + c
        return tot, n

    def top_device_ops(self, n=10):
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:n]
        return [[k, t / 1e6] for k, (t, _) in ops]

    def gaps(self):
        edges = [self.start] + [x for ab in self.busy for x in ab] + [
            self.end]
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]

    def host_op_at(self, t):
        """The innermost host op running at time t, or None."""
        best = None
        for a, b, name in self._host_ops:
            if a <= t <= b and (best is None or b - a < best[1] - best[0]):
                best = (a, b, name)
        return None if best is None else best[2]

    def idle_gaps(self, n=10):
        """The n longest idle gaps as [label, seconds]."""
        longest = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]
        return [[self.host_op_at((a + b) / 2) or "no host op",
                 (b - a) / 1e6] for a, b in longest]


def load(path):
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return TraceSummary(events)
