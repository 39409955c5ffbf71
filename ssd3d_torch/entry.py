"""Entry points of the port: the flagship 3DSSD detector (KITTI Car,
`configs/kitti/3dssd/3dssd.yaml`, 16,384-point scans) with seeded weights.

Counterpart of `__graft_entry__._flagship` / `entry`. Usage:

    from ssd3d_torch.entry import entry
    fn, (points,) = entry(device="cuda")
    detections = fn(points)   # dict of boxes / scores / classes / valid / index
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from ssd3d.config import load_cfg
from ssd3d_torch.models.single_stage import build_detector
from ssd3d_torch.nn.layers import BatchNorm, Dense

FLAGSHIP_CFG = Path(__file__).resolve().parents[1] / "configs" / "kitti" / "3dssd" / "3dssd.yaml"


def init_weights(model: torch.nn.Module, seed: int = 0) -> None:
    """The JAX package's init rules from a seeded CPU generator (so every
    device gets the same numbers): xavier-uniform Dense kernels, zero biases,
    BatchNorm scale 1, bias 0, mean 0, var 1."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, Dense):
                c_in, c_out = mod.kernel.shape
                limit = math.sqrt(6.0 / (c_in + c_out))
                k = torch.rand(c_in, c_out, generator=gen) * (2 * limit) - limit
                mod.kernel.copy_(k)
                mod.bias.zero_()
            elif isinstance(mod, BatchNorm):
                mod.scale.fill_(1.0)
                mod.bias.zero_()
                mod.mean.zero_()
                mod.var.fill_(1.0)


def flagship(shrink: int = 1, compute_dtype: str | None = None,
             device: torch.device | str = "cpu", seed: int = 0):
    """-> (cfg, model, spec, n). `shrink` divides the FPS ranges, sample
    counts and scan size as `__graft_entry__._flagship` does (widths stay);
    `compute_dtype` ("float32" | "bfloat16") overrides TPU.COMPUTE_DTYPE."""
    cfg = load_cfg(str(FLAGSHIP_CFG))
    if shrink > 1:
        for layer in cfg.MODEL.NETWORK.FIRST_STAGE.ARCHITECTURE:
            layer[6] = [r if r == -1 else r // shrink for r in layer[6]]
            layer[8] = [p if p == -1 else p // shrink for p in layer[8]]
        cfg.MODEL.POINTS_NUM_FOR_TRAINING //= shrink
    if compute_dtype is not None:
        cfg.TPU.COMPUTE_DTYPE = compute_dtype
    n = cfg.MODEL.POINTS_NUM_FOR_TRAINING
    model, spec = build_detector(cfg, device=device)
    init_weights(model, seed)
    return cfg, model, spec, n


def entry(device: torch.device | str = "cpu", seed: int = 0):
    """(fn, (points,)): fn runs the flagship forward, decode and NMS on a
    [1, 16384, 4] scan made from `seed`."""
    _, model, spec, n = flagship(device=device, seed=seed)
    pts = np.random.RandomState(seed).randn(1, n, 4).astype(np.float32) * 10
    points = torch.from_numpy(pts).to(device)

    @torch.inference_mode()
    def fn(points: torch.Tensor) -> dict:
        return spec.decode_and_nms(model(points))

    return fn, (points,)
