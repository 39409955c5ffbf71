"""Weight conversion from the JAX package's flax variable tree."""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: str, out: dict) -> None:
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, Mapping):
            _flatten(v, key, out)
        else:
            out[key] = torch.from_numpy(np.array(v, dtype=np.float32, copy=True))


def flax_to_state_dict(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """flax variables ({"params": ..., "batch_stats": ...} as nested dicts of
    numpy arrays) -> the port's state_dict.

    The port names its submodules after the flax scopes and keeps a Dense
    kernel as [c_in, c_out], so every leaf maps by joining its path with
    dots: params/backbone/layer1/mlp0/conv0/conv/kernel becomes
    backbone.layer1.mlp0.conv0.conv.kernel, batch_stats/.../bn/mean becomes
    ....bn.mean."""
    out: dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        if collection in variables:
            _flatten(variables[collection], "", out)
    return out
