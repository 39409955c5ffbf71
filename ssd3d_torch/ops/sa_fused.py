"""Fused set abstraction for inference (counterpart of
`ssd3d/ops/pallas/sa_fused.py`).

One call runs a whole SA layer: for each radius scale, the gather of every
centre's ball from the packed source (features, then xyz), the centre
subtraction, the folded conv + BatchNorm + ReLU chain and the max-pool times
the scale's has-points mask; then the optional aggregation layer. A layer is
given as (kernel [ci, co], bias, inv, shift) with BatchNorm folded to an
affine (`nn.layers.PointConv.fold`). CUDA tensors launch kernel K7
(`csrc/sa_fused.cu`), which keeps the grouped rows in shared memory; CPU
tensors take `sa_fused_multi_plain`. Both compute in f32; the kernel sums
each dot in channel order with fmaf, the plain version in its BLAS's order.

`supports` is K7's envelope, and both entry points raise outside it on every
device, so a CPU run refuses what the card would refuse. Its numbers (the
block's rows, the weight chunk, the limits) are read from
`csrc/sa_fused.cuh`, the header the kernel compiles with.
"""

from __future__ import annotations

import ctypes
import re
from typing import Sequence

import torch

from ssd3d_torch.ops import _build
from ssd3d_torch.ops.grouping import gather_rows_plain


def _header_constants() -> dict[str, int]:
    text = (_build.CSRC / "sa_fused.cuh").read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", text)}


_K7 = _header_constants()
ROWS = _K7["kRows"]  # rows (centres x samples) a K7 block holds
MAX_SCALES, MAX_LAYERS = _K7["kMaxScales"], _K7["kMaxLayers"]
_KC, _COLS = _K7["kKC"], _K7["kCols"]  # K7's staged weight chunk
_MAX_SMEM = _K7["kMaxSmem"]  # bytes of shared memory a block may opt in to

Layer = Sequence[torch.Tensor]  # (kernel [ci, co], bias, inv, shift)


def smem_bytes(cp: int, ns_list: Sequence[int], widths_list: Sequence[Sequence[int]]) -> int:
    """K7's shared memory for one launch: the two row buffers (strides padded
    to odd word counts), the weight chunk and the pooled scales."""
    sa, sb = cp, 1
    for widths in widths_list:
        for i, c in enumerate(widths):
            if i % 2 == 0:
                sb = max(sb, c)
            else:
                sa = max(sa, c)
    tm = ROWS // max(ns_list)
    sum_c = sum(w[-1] for w in widths_list)
    return 4 * (ROWS * ((sa | 1) + (sb | 1)) + _KC * _COLS + tm * sum_c)


def supports(cp: int, ns_list: Sequence[int], widths_list: Sequence[Sequence[int]]) -> bool:
    """K7's envelope: 1 to 4 scales of 1 to 4 layers, each ns a divisor of
    128 (a block holds 128 // max(ns) whole balls), at least the three xyz
    columns, and the buffers within the H100's 227 KB of shared memory."""
    return (cp >= 3 and 1 <= len(ns_list) <= MAX_SCALES and len(widths_list) == len(ns_list)
            and all(1 <= ns <= ROWS and ROWS % ns == 0 for ns in ns_list)
            and all(1 <= len(w) <= MAX_LAYERS for w in widths_list)
            and smem_bytes(cp, ns_list, widths_list) <= _MAX_SMEM)


def _apply(x: torch.Tensor, layer: Layer) -> torch.Tensor:
    w, b, inv, shift = layer
    return torch.relu((torch.matmul(x, w) + b) * inv + shift)


def sa_fused_multi_plain(src, idx_list, centers, masks, layers_list, agg_layer=None):
    """The plain version: the same function as K7, in PyTorch (f32)."""
    cf = src.shape[-1] - 3
    feats = []
    for k, (idx, layers) in enumerate(zip(idx_list, layers_list)):
        b, m, ns = idx.shape
        g = gather_rows_plain(src, idx.reshape(b, m * ns)).reshape(b, m, ns, -1)
        x = torch.cat([g[..., :cf], g[..., cf:] - centers[:, :, None, :]], dim=-1)
        for layer in layers:
            x = _apply(x, layer)
        feats.append(x.amax(2) * masks[..., k:k + 1])
    feat = torch.cat(feats, dim=-1)
    return _apply(feat, agg_layer) if agg_layer is not None else feat


def _sa_fused_cuda(src, idx_list, centers, masks, layers_list, agg_layer):
    b, n, cp = src.shape
    m = centers.shape[1]
    entries = [layer for layers in layers_list for layer in layers]
    if agg_layer is not None:
        entries.append(agg_layer)
    parts, off, ci, co, pos = [], [], [], [], 0
    for w, bias, inv, shift in entries:
        off.append(pos)
        ci.append(w.shape[0])
        co.append(w.shape[1])
        for t in (w, bias, inv, shift):
            parts.append(t.detach().float().reshape(-1))
            pos += parts[-1].numel()
    params = torch.cat(parts)
    idx_list = [idx.to(torch.int32).contiguous() for idx in idx_list]
    src, centers, masks = src.contiguous(), centers.contiguous(), masks.float().contiguous()
    c_out = co[-1] if agg_layer is not None else sum(layers[-1][0].shape[1]
                                                     for layers in layers_list)
    out = torch.empty(b, m, c_out, dtype=torch.float32, device=src.device)
    r = len(idx_list)
    arrays = [(ctypes.c_int * r)(*[idx.shape[2] for idx in idx_list]),
              (ctypes.c_int * r)(*[len(layers) for layers in layers_list]),
              (ctypes.c_void_p * r)(*[idx.data_ptr() for idx in idx_list]),
              (ctypes.c_int * len(ci))(*ci), (ctypes.c_int * len(co))(*co),
              (ctypes.c_longlong * len(off))(*off)]
    ns_a, nl_a, idx_a, ci_a, co_a, off_a = [ctypes.cast(a, ctypes.c_void_p) for a in arrays]
    _build.SA_FUSED(src.data_ptr(), centers.data_ptr(), masks.data_ptr(), params.data_ptr(),
                    out.data_ptr(), b, n, m, cp, r, ns_a, nl_a, idx_a,
                    int(agg_layer is not None), ci_a, co_a, off_a)
    return out


def sa_fused_multi(src: torch.Tensor, idx_list, centers: torch.Tensor, masks: torch.Tensor,
                   layers_list, agg_layer=None) -> torch.Tensor:
    """Every scale of one SA layer, then the aggregation layer.

    src: f32 [b, n, cf + 3] (features, then xyz); idx_list: per scale int
    [b, m, ns_k], empty balls already pointing at row 0; centers: f32
    [b, m, 3]; masks: [b, m, R] (has-points per scale, applied to each pooled
    scale before the aggregation); layers_list: per scale a list of
    (kernel, bias, inv, shift); agg_layer: one such tuple or None.
    -> f32 [b, m, c_out]. Inference only: no gradient."""
    if src.dim() != 3 or src.dtype != torch.float32:
        raise ValueError(f"sa_fused_multi: src must be f32 [b, n, c], got {src.dtype} "
                         f"{tuple(src.shape)}")
    b, m = centers.shape[:2]
    ns_list = [idx.shape[2] for idx in idx_list]
    widths = [[w.shape[1] for w, *_ in layers] for layers in layers_list]
    if any(tuple(idx.shape[:2]) != (b, m) for idx in idx_list) or masks.shape != (b, m, len(idx_list)):
        raise ValueError("sa_fused_multi: idx, centers and masks disagree on [b, m, R]")
    if not supports(src.shape[2], ns_list, widths):
        raise ValueError(f"sa_fused_multi: outside K7's envelope (cp={src.shape[2]}, "
                         f"ns={ns_list}, widths={widths}); gate the call with supports()")
    with torch.no_grad():
        if _build.require_cuda("sa_fused_multi", src, centers, masks, *idx_list):
            return _sa_fused_cuda(src, idx_list, centers, masks, layers_list, agg_layer)
        return sa_fused_multi_plain(src, idx_list, centers, masks, layers_list, agg_layer)


def sa_fused(src: torch.Tensor, idx: torch.Tensor, centers: torch.Tensor, layers) -> torch.Tensor:
    """One scale, unmasked (the JAX package's `sa_fused_pallas`): src [b, n,
    cf + 3]; idx int [b, m, ns]; centers [b, m, 3] -> f32 [b, m, c_out]."""
    ones = torch.ones(idx.shape[0], idx.shape[1], 1, dtype=torch.float32, device=src.device)
    return sa_fused_multi(src, [idx], centers, ones, [layers])
