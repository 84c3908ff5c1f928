"""Tracing / profiling utilities.

Own copy of the JAX package's `semantic_meshes/profiling.py`, on
`torch.profiler`. The reference has no tracing (SURVEY.md §5: wall-clock
anecdotes and tqdm only). Here:
- `PhaseTimers`: per-phase accumulated wall-clock timings with a report()
  string; while a `torch.profiler` runs, each phase is also a
  `record_function` range, a user annotation in a trace,
- `annotate(name)`: a phase of the module's global timers,
- `span(name)`: a range of the hot path (the `smt.*` names, see below):
  while a profiler runs, `annotate(name)`; otherwise one shared null
  context, so an untraced call costs one `_profiler_enabled()` check,
- `timings()`: the global timers' `as_dict()`,
- `counter_max(name, value)` / `counters()`: the program's counters, each
  the largest value recorded under its name in this process (set-up
  facts the benchmark reads: `dense.global_rows`, the largest global
  bucket a dense budget probe found in one view, and `dense.n_global`,
  the cap sized from it),
- `trace_to(dir, device)`: a trace of the host and, on a CUDA device, of
  the card, written as a Chrome trace `dir/trace.json` (viewable in
  perfetto),
- `times_ms(fn, reps, device)`: each call's time, from CUDA events on a
  card (the bench and the microbenches time with it).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from .data import resolve_device

TRACE_FILE = "trace.json"
_NULL = contextlib.nullcontext()  # reusable: it holds no state


class PhaseTimers:
    """Accumulate wall-clock per named phase (host-side; pair with
    torch.cuda.synchronize at phase ends for device-accurate numbers)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.durations = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name):
        with (record_function(name) if torch.autograd._profiler_enabled()
              else _NULL):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                self.totals[name] += dt
                self.counts[name] += 1
                self.durations[name].append(dt)

    def record(self, name, seconds):
        """Record an already-measured duration (e.g. process start /
        import time stamped before the timers object could exist)."""
        self.totals[name] += float(seconds)
        self.counts[name] += 1
        self.durations[name].append(float(seconds))

    def median(self, name):
        """Median call duration in seconds (0.0 if the phase never ran):
        the steady-state number, free of a first call's one-time costs
        (kernel builds, allocator growth)."""
        d = sorted(self.durations[name])
        if not d:
            return 0.0
        n = len(d)
        mid = n // 2
        return d[mid] if n % 2 else 0.5 * (d[mid - 1] + d[mid])

    def as_dict(self):
        """Machine-readable snapshot: {phase: {total_s, calls, median_s}}
        (benchmark scripts parse this to separate one-time costs from
        per-call rates)."""
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "calls": self.counts[name],
                "median_s": round(self.median(name), 4),
            }
            for name in self.totals
        }

    def report(self):
        lines = ["phase timings:"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(
                f"  {name}: {self.totals[name]:.3f}s "
                f"({self.counts[name]} calls, "
                f"{self.totals[name] / max(self.counts[name], 1) * 1e3:.1f} "
                "ms/call, "
                f"{self.median(name) * 1e3:.1f} ms median)"
            )
        return "\n".join(lines)


_global_timers = PhaseTimers()


def annotate(name):
    """Module-level phase annotation using the global timer registry."""
    return _global_timers.phase(name)


def span(name):
    """`annotate(name)` while a torch.profiler runs, else the one shared
    null context (no clock read, no range, no timer entry)."""
    if torch.autograd._profiler_enabled():
        return _global_timers.phase(name)
    return _NULL


def report():
    return _global_timers.report()


def timings():
    """The global timers: {phase: {total_s, calls, median_s}}."""
    return _global_timers.as_dict()


_counters = {}


def counter_max(name, value):
    """Raise counter `name` to `value` (host int) if it is below it."""
    value = int(value)
    _counters[name] = max(_counters.get(name, value), value)


def counters():
    """The program's counters: {name: largest value recorded}."""
    return dict(_counters)


def times_ms(fn, reps, device, warmup=0):
    """The time in ms of each of `reps` calls of fn(), after `warmup`
    calls left untimed. On a CUDA device: the device's time between CUDA
    events recorded on the current stream before and after the call,
    read after it synchronizes (the host's clock would time the enqueue).
    On the CPU: the host's clock around the call, the CPU's own time
    (its ops run synchronously)."""
    device = torch.device(device)
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
    return out


@contextlib.contextmanager
def trace_to(log_dir, device="cuda"):
    """Trace the block into `log_dir/trace.json` (Chrome trace format):
    host events and user annotations, plus the card's kernels and copies
    when `device` is a CUDA device. Yields the running profiler."""
    device = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        prof.stop()
        prof.export_chrome_trace(os.path.join(str(log_dir), TRACE_FILE))
