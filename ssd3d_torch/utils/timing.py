"""Device time of a call on the card, the yardstick of every kernel time in
`chip_smoke.py` and `ssd3d_torch/utils/gather_ab.py`."""

from __future__ import annotations

import time

import torch

# cycles a second of the H100 SXM's top SM clock: sizes the stream hold below
H100_SM_CLOCK_HZ = 1.98e9


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Device ms of one fn(): one pair of CUDA events around `iters`
    back-to-back calls, after `warmup` calls, divided by `iters`. A sleep
    kernel ahead of the start event holds the stream while the host enqueues
    the calls (1.25 x the host's enqueue time of a call, measured, times
    `iters`, at most 200 ms), so the window holds the device's time and not
    the wrapper's host time; a fn that synchronizes inside still waits for
    its host part."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    hold_s = min(0.2, 1.25 * iters * enqueue_s + 1e-4)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(hold_s * H100_SM_CLOCK_HZ))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    held = not start.query()  # the device had not reached the window yet
    end.synchronize()
    ms = start.elapsed_time(end) / iters
    if not held:
        print(f"  (cuda_ms: the host was still enqueueing when the window opened: "
              f"{ms:.3f} ms a call includes host time)", flush=True)
    return ms

