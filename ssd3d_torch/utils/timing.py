"""Device time of a call on the card, the yardstick of every kernel time in
`chip_smoke.py` and `ssd3d_torch/utils/gather_ab.py`."""

from __future__ import annotations

import time

import torch

# cycles a second of the H100 SXM's top SM clock: sizes the stream hold below
H100_SM_CLOCK_HZ = 1.98e9


def _enqueue_s(fn, warmup: int) -> float:
    """The host's time to enqueue one fn(), after `warmup` calls, measured
    with the device idle before and after."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    return enqueue_s


def _hold(seconds: float) -> None:
    """A sleep kernel that holds the stream for about `seconds`."""
    torch.cuda._sleep(int(seconds * H100_SM_CLOCK_HZ))


def _warn_unheld(name: str, ms: float) -> None:
    print(f"  ({name}: the host was still enqueueing when the window opened: "
          f"{ms:.3f} ms a call includes host time)", flush=True)


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Device ms of one fn(): one pair of CUDA events around `iters`
    back-to-back calls, after `warmup` calls, divided by `iters`. A sleep
    kernel ahead of the start event holds the stream while the host enqueues
    the calls (1.25 x the host's enqueue time of a call, measured, times
    `iters`, plus 1 ms, at most 200 ms), so the window holds the device's
    time and not the wrapper's host time; a fn that synchronizes inside
    still waits for its host part."""
    hold_s = min(0.2, 1.25 * iters * _enqueue_s(fn, warmup) + 1e-3)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    _hold(hold_s)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    held = not start.query()  # the device had not reached the window yet
    end.synchronize()
    ms = start.elapsed_time(end) / iters
    if not held:
        _warn_unheld("cuda_ms", ms)
    return ms


def cuda_ms_each(fn, before, iters: int, warmup: int = 1) -> float:
    """Device ms of one fn() that runs after before(): before each call,
    before() runs, then the stream is held while the host enqueues the call
    (as `cuda_ms` does, for one call), and a pair of CUDA events brackets
    the call alone. The mean over `iters` calls."""
    hold_s = min(0.05, 1.25 * _enqueue_s(fn, warmup) + 1e-3)
    pairs, held = [], True
    for _ in range(iters):
        before()
        _hold(hold_s)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        held = held and not start.query()  # the device had not reached this window yet
        pairs.append((start, end))
    torch.cuda.synchronize()
    ms = sum(s.elapsed_time(e) for s, e in pairs) / iters
    if not held:
        _warn_unheld("cuda_ms_each", ms)
    return ms


# bytes written between calls by `cuda_ms_cold`: more than the H100's 50 MB L2
L2_FLUSH_BYTES = 256 << 20
_flush: dict[torch.device, torch.Tensor] = {}


def cuda_ms_cold(fn, iters: int, warmup: int = 1) -> float:
    """Device ms of one fn() that finds the L2 cache cold, as a caller that
    wrote other data since its inputs finds it: `cuda_ms_each` with 256 MB
    written before each call."""
    dev = torch.device("cuda", torch.cuda.current_device())
    if dev not in _flush:
        _flush[dev] = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    return cuda_ms_each(fn, _flush[dev].zero_, iters, warmup)
