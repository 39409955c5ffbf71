"""Profiling hooks (counterpart of `ssd3d/utils/profiling.py`; the
reference has none, SURVEY §5: only wall-clock prints).

- `trace(log_dir)`: a context manager around `torch.profiler` (CPU and,
  where there is a card, CUDA activities) that writes a Chrome trace,
  `<log_dir>/trace_<time>.pt.trace.json.gz`, and yields the profiler (its
  `key_averages()` and `events()` stay readable after the block).
- `summarize_trace(log_dir)`: the newest trace under `log_dir` summed by
  name or by category, readable without TensorBoard or Perfetto.
- `span(name)`: a span at one of the port's layer boundaries, the
  profiler's own `record_function` while a profiler runs, else a shared
  no-op. Every span name starts with `ssd3d.` (the custom ops are
  `ssd3d::<op>`); spans nest on the calling thread.
- `span_device_times(events)`: the profiler's events reduced to each
  span's device time and kernel count.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import time

import torch

# the trace's event categories of work on the card
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "ssd3d."
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A span named `name` (`ssd3d.<layer>`) around a layer of the port:
    while a profiler runs, `torch.profiler.record_function(name)`, an event
    of the profiler's own on its clock, whose parent is the span around it;
    otherwise one shared no-op context, so that a span costs one check of
    the profiler's state when nothing traces (`torch.export` included)."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def _linked(e) -> tuple[float, int]:
    """Device µs and kernels linked to event `e` or to an event inside it."""
    us = sum(k.duration for k in e.kernels)
    n = sum(1 for k in e.kernels if not k.name.startswith(("Memcpy", "Memset")))
    for c in e.cpu_children:
        cu, cn = _linked(c)
        us, n = us + cu, n + cn
    return us, n


def span_device_times(events) -> dict[str, tuple[float, int]]:
    """A profile's events (`prof.events()`) -> {span name: (device µs, kernels)}
    summed over every `ssd3d.` span of that name: the device work (kernels,
    copies, sets) that the profiler links to the span or to an op inside
    it, and that of every outermost op of another thread that starts inside
    the span's time range, since the autograd engine launches a backward's
    kernels from a thread of its own. Kernels count launches of kernels
    alone."""
    host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    outer = [e for e in host if e.cpu_parent is None]
    out: dict[str, tuple[float, int]] = {}
    for s in host:
        if not s.name.startswith(SPAN_PREFIX):
            continue
        us, n = _linked(s)
        t0, t1 = s.time_range.start, s.time_range.end
        for e in outer:
            if e.thread != s.thread and t0 <= e.time_range.start <= t1:
                eu, en = _linked(e)
                us, n = us + eu, n + en
        pu, pn = out.get(s.name, (0.0, 0))
        out[s.name] = (pu + us, pn + n)
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; write its Chrome trace under `log_dir`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        stamp = time.strftime("%Y%m%d_%H%M%S")
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{stamp}_{os.getpid()}"
                                                       ".pt.trace.json.gz"))


def _newest_trace(log_dir: str) -> str:
    files = [f for pattern in ("*.trace.json.gz", "*.trace.json")
             for f in glob.glob(os.path.join(log_dir, "**", pattern), recursive=True)]
    if not files:
        raise FileNotFoundError(f"no trace under {log_dir}")
    return max(files, key=os.path.getmtime)


def summarize_trace(log_dir: str, top: int = 30, by_category: bool = False):
    """The newest trace under `log_dir` (`trace`'s, or any Chrome trace
    named `*.trace.json[.gz]`) -> [(name, total ms)], largest first, at
    most `top`.

    Where the trace holds work on the card, it sums the device events
    (categories `kernel`, `gpu_memcpy`, `gpu_memset`) by name, or with
    `by_category` by category. A trace of the CPU alone has none: it sums
    the `cpu_op` events instead, each with its inclusive time, so an op's
    total holds the ops it called, which are listed too."""
    path = _newest_trace(log_dir)
    with (gzip.open(path, "rt") if path.endswith(".gz") else open(path)) as f:
        events = json.load(f).get("traceEvents", [])
    timed = [e for e in events if e.get("ph") == "X" and "dur" in e]
    wanted = [e for e in timed if e.get("cat") in DEVICE_CATEGORIES]
    if not wanted:
        wanted = [e for e in timed if e.get("cat") == "cpu_op"]
    agg: collections.Counter = collections.Counter()
    for e in wanted:
        agg[e["cat"] if by_category else e.get("name", "?")] += e["dur"]
    return [(k, v / 1e3) for k, v in agg.most_common(top)]
