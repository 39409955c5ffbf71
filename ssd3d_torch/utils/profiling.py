"""Profiling hooks (counterpart of `ssd3d/utils/profiling.py`; the
reference has none, SURVEY §5: only wall-clock prints).

- `trace(log_dir)`: a context manager around `torch.profiler` (CPU and,
  where there is a card, CUDA activities) that writes a Chrome trace,
  `<log_dir>/trace_<time>.pt.trace.json.gz`, and yields the profiler (its
  `key_averages()` and `events()` stay readable after the block).
- `summarize_trace(log_dir)`: the newest trace under `log_dir` summed by
  name or by category, readable without TensorBoard or Perfetto.
- `Stopwatch`: a step timer that waits for the step's output (CUDA
  launches return before the card is done).
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
from torch.utils import _pytree

# the trace's event categories of work on the card
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


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


class Stopwatch:
    """Step timing that waits for the work: `lap(output)` fetches one
    element of the output's first tensor leaf before it reads the clock."""

    def __init__(self):
        self._t0 = None
        self.laps: list = []

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def lap(self, output=None) -> float:
        if output is not None:
            leaf = next((x for x in _pytree.tree_leaves(output) if isinstance(x, torch.Tensor)),
                        None)
            if leaf is not None:
                leaf.reshape(-1)[:1].tolist()  # waits for the device
        dt = time.perf_counter() - self._t0
        self.laps.append(dt)
        self._t0 = time.perf_counter()
        return dt

    @property
    def mean(self) -> float:
        return sum(self.laps) / max(len(self.laps), 1)
