"""The traced stretches of a `--trace 1` run: `torch.profiler` over a few
whole requests in the middle of the window (`Tracer`), reduced to what the
per-layer readers need.

- device intervals: every kernel, memcpy and memset on the card, and the
  union of them (busy time: overlapping work counts once);
- the device time of each custom op (`ssd3d::*`): the kernels the profiler
  links to the op or to an op inside it, so that an op's kernels are found
  by the op's name whatever the kernels are called;
- the device time and kernels under each of the program's spans
  (`ssd3d.*`), summed by name (`span_device_us`);
- host ops and the benchmark's own spans (`portbench.request`, `.h2d`,
  `.d2h`), to name what the host was doing during each idle gap;
- the first stretch's host-clock length and each stretch's number of
  requests.
"""

from __future__ import annotations

import time

import torch

DEVICE = torch.autograd.DeviceType.CUDA
# the program's spans (`ssd3d_torch/utils/profiling.span`); its custom ops are `ssd3d::<op>`
SPAN_PREFIX = "ssd3d."


class Tracer:
    """Two stretches of `n` whole requests each, from request `first` on:
    the first traced for the card's activity alone (the profiler's least
    cost to the host, so its busy and idle time stand nearest an untraced
    run's), the second for the host's ops too, which name each kernel's op
    and each idle gap's host work (under this profiler the host runs
    slower, so that stretch's gaps are longer than an untraced run's)."""

    def __init__(self, device: torch.device, first: int, n: int):
        self.device, self.first, self.n = device, first, n
        self.prof = [None, None]
        self.times = [[0.0, 0.0], [0.0, 0.0]]

    def last(self) -> int:
        """The index after the last traced request."""
        return self.first + 2 * self.n

    def before(self, i: int) -> None:
        """Before request i."""
        if i in (self.first, self.first + self.n):
            k = 0 if i == self.first else 1
            torch.cuda.synchronize(self.device)
            acts = [torch.profiler.ProfilerActivity.CUDA]
            if k == 1:
                acts.append(torch.profiler.ProfilerActivity.CPU)
            self.prof[k] = torch.profiler.profile(activities=acts)
            self.prof[k].start()
            torch.cuda.synchronize(self.device)
            self.times[k][0] = time.perf_counter()

    def after(self, i: int) -> None:
        """After request i."""
        if i in (self.first + self.n - 1, self.first + 2 * self.n - 1):
            k = 0 if i == self.first + self.n - 1 else 1
            torch.cuda.synchronize(self.device)
            self.times[k][1] = time.perf_counter()
            self.prof[k].stop()

    def read(self) -> dict:
        """-> the reduced trace (see the module's docstring): `window_s`,
        `busy_s`, `device`, `kernels` and `merged` of the first stretch,
        `op_us`, `span_us` and `host` (with `labelled`, the second
        stretch's merged device intervals) of the second."""
        out = {"requests": self.n}
        for k, prof in enumerate(self.prof):
            events = list(prof.events())
            device = sorted(((e.time_range.start, e.time_range.end, e.name) for e in events
                             if e.device_type == DEVICE
                             and not getattr(e, "is_user_annotation", False)),
                            key=lambda t: t[0])
            merged = []
            for s, e, _ in device:
                if merged and s <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], e)
                else:
                    merged.append([s, e])
            if k == 0:
                out.update(window_s=self.times[0][1] - self.times[0][0], device=device,
                           busy_s=sum(e - s for s, e in merged) / 1e6, merged=merged,
                           kernels=[d for d in device
                                    if not d[2].startswith(("Memcpy", "Memset", "[memory]"))])
                continue
            cpu = [e for e in events if e.device_type != DEVICE]
            op_us: dict[str, float] = {}
            for e in cpu:
                if e.name.startswith("ssd3d::"):
                    # each op's kernels: those the profiler linked to it or to an op inside it
                    op_us[e.name] = op_us.get(e.name, 0.0) + _linked(e)[0]
            out.update(op_us=op_us, span_us=span_device_us(cpu), labelled=merged,
                       host=sorted((e.time_range.start, e.time_range.end, e.name) for e in cpu))
        return out


def _linked(e) -> tuple[float, int]:
    """Device µs and kernels that the profiler links to event `e` or to an
    event inside it."""
    us = sum(k.duration for k in e.kernels)
    n = sum(1 for k in e.kernels if not k.name.startswith(("Memcpy", "Memset")))
    for c in e.cpu_children:
        cu, cn = _linked(c)
        us, n = us + cu, n + cn
    return us, n


def span_device_us(host) -> dict[str, list]:
    """The host events of a stretch (the profiler's `FunctionEvent`s) ->
    {span name: [device µs, kernels]}, summed over every span of that name
    (a host event whose name starts with `ssd3d.`): the device work
    (kernels, copies, sets) that the profiler links to the span or to an op
    inside it, and that of every outermost event of another thread that
    starts inside the span's range, since the autograd engine launches a
    backward's kernels from a thread of its own. Kernels count launches of
    kernels alone. The arithmetic of the port's
    `utils/profiling.span_device_times`."""
    outer = [e for e in host if e.cpu_parent is None]
    out: dict[str, list] = {}
    for s in host:
        if not s.name.startswith(SPAN_PREFIX):
            continue
        us, n = _linked(s)
        t0, t1 = s.time_range.start, s.time_range.end
        for e in outer:
            if e.thread != s.thread and t0 <= e.time_range.start <= t1:
                eu, en = _linked(e)
                us, n = us + eu, n + en
        total = out.setdefault(s.name, [0.0, 0])
        total[0] += us
        total[1] += n
    return out


def breakdown(tr: dict, top: int = 10) -> dict:
    """The device operations that took most time (first stretch), and the
    longest idle gaps between device work (second stretch), each named by
    the innermost host op or span running at the gap's middle."""
    by_name: dict[str, float] = {}
    for s, e, name in tr["device"]:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    merged, host = tr["labelled"], tr["host"]
    gaps = sorted(((merged[k + 1][0] - merged[k][1], (merged[k][1] + merged[k + 1][0]) / 2)
                   for k in range(len(merged) - 1)), reverse=True)[:top]
    named = []
    for length, mid in gaps:
        inner = [h for h in host if h[0] <= mid <= h[1]]
        label = min(inner, key=lambda h: h[1] - h[0])[2] if inner else "between requests"
        named.append([label, length / 1e6])
    return {"device_ops": [[n, t] for n, t in ops], "idle_gaps": named}


# ---------------------------------------------------------------- reductions

# PyTorch's own kernels that are not sorts or selections: elementwise,
# index and gather, copy, reduction and concatenation kernels
_SORTS = ("sort", "Sort", "topk", "radix", "Radix")


def is_eager(name: str) -> bool:
    return "at::native" in name and not any(s in name for s in _SORTS)


def idle_pct(tr: dict) -> float:
    """The share of the stretch in which nothing ran on the card."""
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def eager_ms(tr: dict) -> float:
    """Device ms a request in PyTorch's eager kernels."""
    return sum(e - s for s, e, name in tr["kernels"] if is_eager(name)) / 1e3 / tr["requests"]


def launches(tr: dict) -> float:
    """Kernel launches a request."""
    return len(tr["kernels"]) / tr["requests"]


def op_roofline_pct(tr: dict, op: str, bound_s: float) -> float | None:
    """Σ least time ÷ Σ device time of the kernels launched inside `op`, in %;
    None where no such kernel ran (`bound_s` is one request's least time)."""
    t = tr["op_us"].get(op, 0.0) / 1e6
    if t <= 0.0 or bound_s <= 0.0:
        return None
    return 100.0 * bound_s * tr["requests"] / t
