"""Readings of the program's own spans in the host-op stretch of a
`--trace 1` run (the second of `trace.Tracer`'s stretches), from what
`Tracer.read()` already returns: `host`, every host event of that stretch
as (start µs, end µs, name), the program's spans and the CUDA runtime's
calls among them, and `labelled`, the stretch's merged device intervals,
on the same clock; and `span_us`, the device µs and kernels under each
span, summed by name (`trace.span_device_us`).

The port opens a span at each of its layer boundaries
(`ssd3d_torch/utils/profiling.span`): `ssd3d.infer` around a request's
inference, `ssd3d.train.step` around an optimizer step, and the layers'
spans inside them (PERF.md lists them). Where the program has no such span
(a build without them), each reading is None and its metric is left out.

Readers in `metrics/`: `program_idle_ms.infer` / `.train` (`idle_ms` in
`ssd3d.infer` / `ssd3d.train.step`), `syncs.infer` / `.train` (`calls` of
`SYNC`, same spans), `update_launches.train` (`calls` of `LAUNCH` in
`ssd3d.train.update`), `roi_pool_ms.infer` (`device_ms` of
`ssd3d.rcnn.pool`). The host-op stretch runs slower on the host than an
untraced run, so `program_idle_ms.*` reads above an untraced run's idle.
"""

from __future__ import annotations

import re

# host-blocking CUDA API calls (`cuda*` and `cu*`): the stream, device and event
# synchronisations and the synchronous copies (a `.item()` or a copy to
# pageable memory is an asynchronous copy and then a stream synchronisation)
SYNC = re.compile(r"^(cuda(Stream|Device|Event)Synchronize|cu(Stream|Ctx|Event)Synchronize"
                  r"|cudaMemcpy(2D|3D)?)(_v\d+)?$")
# a kernel's launch through either API (Triton launches with `cuLaunchKernel`)
LAUNCH = re.compile(r"^(cudaLaunch(Cooperative)?Kernel(ExC)?|cuLaunch(Cooperative)?Kernel(Ex)?)"
                    r"(_v\d+)?$")


def spans(tr: dict, name: str) -> list[tuple[float, float]]:
    """The (start, end) µs of every span called `name` in the stretch."""
    return [(s, e) for s, e, n in tr["host"] if n == name]


def idle_ms(tr: dict, name: str) -> float | None:
    """Device-idle ms a request inside the spans called `name`: each span's
    length less the part of it that the stretch's merged device intervals
    cover. None where the stretch has no such span."""
    found = spans(tr, name)
    if not found:
        return None
    idle = 0.0
    for s, e in found:
        busy = sum(min(e, d1) - max(s, d0) for d0, d1 in tr["labelled"] if d0 < e and d1 > s)
        idle += (e - s) - busy
    return idle / 1e3 / tr["requests"]


def calls(tr: dict, name: str, pattern: re.Pattern) -> float | None:
    """Host calls a request whose name `pattern` matches and which start
    inside a span called `name` (on any thread). None where the stretch has
    no such span."""
    found = spans(tr, name)
    if not found:
        return None
    n = sum(1 for s, _, call in tr["host"] if pattern.match(call)
            and any(a <= s <= b for a, b in found))
    return n / tr["requests"]


def device_ms(tr: dict, name: str) -> float | None:
    """Device ms a request under the spans called `name` (the kernels,
    copies and sets linked to them, `span_us`). None where the stretch has
    no such span."""
    found = tr.get("span_us", {}).get(name)
    return None if found is None else found[0] / 1e3 / tr["requests"]
