"""Seeded weights for the program and the reference alike.

The reference lists every tensor of the model by name, shape and kind
(`reference.nets.Detector.spec`); one uniform draw from a generator on the
target device, seeded from `--seed`, fills them all, then each slice is
scaled to its kind: Xavier-uniform kernels, small biases, and BatchNorm
scales, shifts and running statistics near their trained ranges, so that
eval-mode BatchNorm does real arithmetic. The program gets a copy through
`load_state_dict(strict=True)`, which also checks that both name every
tensor alike.
"""

from __future__ import annotations

import math

import torch

# kind -> (low, high) of the uniform draw; kernels take +-sqrt(6 / (c_in + c_out))
RANGES = {"bias": (-0.05, 0.05), "scale": (0.8, 1.2), "mean": (-0.1, 0.1), "var": (0.8, 1.2)}


def make(spec, seed: int, device: torch.device) -> dict:
    """spec [(name, shape, kind)] -> {name: float32 tensor on device}."""
    sizes = [math.prod(shape) for _, shape, _ in spec]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for (name, shape, kind), size in zip(spec, sizes):
        u = flat[at:at + size].view(shape)
        at += size
        if kind == "kernel":
            lo = -math.sqrt(6.0 / (shape[0] + shape[1]))
            hi = -lo
        else:
            lo, hi = RANGES[kind]
        out[name] = u * (hi - lo) + lo
    return out
