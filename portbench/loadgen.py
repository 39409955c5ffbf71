"""The general traffic generator: reads a mix's parameters
(`traffic/<mix>.json`) and makes its inputs from the seed: a pool of
`pool` distinct scenes (`scenes.py`), and each request's rows of it, taken
in turn. How a kind of mix drives the program with them is
`loops/<kind>.py`'s.

Every seed gives the same sizes: only the scenes differ.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from portbench import scenes

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"


def load(name: str) -> dict:
    return json.loads((TRAFFIC_DIR / f"{name}.json").read_text())


def make_pool(mix: dict, seed: int, n_points: int, device: torch.device) -> dict:
    """The mix's scans as the client holds them: host tensors, in pinned
    memory where the scans go to a card (as a loader that pins its batches
    hands them over)."""
    pool = {k: torch.from_numpy(v) for k, v in
            scenes.scan_pool(seed, mix["pool"], n_points, mix["max_cars"]).items()}
    if device.type == "cuda":
        pool = {k: v.pin_memory() for k, v in pool.items()}
    return pool


def request_rows(mix: dict, i: int, rank: int | None = 0) -> slice:
    """The pool rows of request i: the next `batch` x `ranks` rows in turn
    (the pool holds a whole number of them), of which rank r takes the r-th
    `batch` rows (all of them with `rank` None)."""
    step = mix["batch"] * mix.get("ranks", 1)
    if mix["pool"] % step:
        raise ValueError("loadgen: the pool must hold a whole number of batches")
    start = (i * step) % mix["pool"]
    if rank is None:
        return slice(start, start + step)
    return slice(start + rank * mix["batch"], start + (rank + 1) * mix["batch"])


class Window:
    """The measured requests: each one's start and end on the host clock."""

    def __init__(self):
        self.t0 = self.t1 = 0.0
        self.starts: list[float] = []
        self.ends: list[float] = []
        self.scans: list[int] = []
        self.failed = 0

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def latencies_ms(self) -> list[float]:
        return [(e - s) * 1e3 for s, e in zip(self.starts, self.ends)]


def train_batch(pool: dict, mix: dict, step: int, device: torch.device,
                rank: int | None = 0) -> dict:
    """The batch of optimizer step `step` on rank `rank` (None: the global
    batch of every rank's rows): the next scenes of the pool in turn, with
    their boxes, on the card."""
    rows = request_rows(mix, step, rank)
    return {k: pool[k][rows].to(device) for k in ("points", "gt_boxes", "gt_labels")}
