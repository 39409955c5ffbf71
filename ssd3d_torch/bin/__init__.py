"""The port's command-line entry points (counterparts of `ssd3d/bin/*`):
`python -m ssd3d_torch.bin.{preprocess,train,evaluate,test}`. Each takes
`--device` (default `cuda`); without a card the default stops the command
with a clear error instead of carrying on on the CPU."""

from __future__ import annotations

import torch

from ssd3d_torch.ops import _build


def cli_device(name: str) -> torch.device:
    """`--device` -> the device, or exit with the reason where it is missing."""
    try:
        return _build.resolve_device(name)
    except RuntimeError as exc:
        raise SystemExit(f"{exc} On the command line: --device cpu.") from None
