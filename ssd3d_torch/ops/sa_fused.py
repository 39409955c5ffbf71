"""Fused set abstraction for inference (counterpart of
`ssd3d/ops/pallas/sa_fused.py`).

One call runs a whole SA layer: for each radius scale, the gather of every
centre's ball from the packed source (features, then xyz), the centre
subtraction, the folded conv + BatchNorm + ReLU chain and the max-pool times
the scale's has-points mask; then the optional aggregation layer. A layer is
given as (kernel [ci, co], bias, inv, shift) with BatchNorm folded to an
affine (`nn.layers.PointConv.fold`). CUDA tensors launch kernel K7
(`csrc/sa_fused.cu`), which keeps the grouped rows in shared memory; CPU
tensors take `sa_fused_multi_plain`. Both compute in f32.

K7 has two routes, chosen by `sa_fused_route` from the shape: "wgmma", the
tensor cores in 3xTF32 (each f32 operand split into a TF32 big part and a
TF32 remainder, `tf32_round`, and big.big + big.small + small.big summed in
f32), for scales whose layers are at most 256 wide; "fma", the first design's
f32 FMA GEMM, for the wider ones. The wgmma route takes its weights staged
by `stage_weights`, once per call.

`supports` is K7's envelope (either route), and both entry points raise
outside it on every device, so a CPU run refuses what the card would refuse.
Its numbers (the block's rows, the weight chunks and stages, the limits) are
read from `csrc/sa_fused.cuh`, the header the kernel compiles with.
"""

from __future__ import annotations

import ctypes
import functools
import re
from typing import Sequence

import torch

from ssd3d_torch.ops import _build
from ssd3d_torch.ops.grouping import gather_rows_plain


def _header_constants() -> dict[str, int]:
    text = (_build.CSRC / "sa_fused.cuh").read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", text)}


_K7 = _header_constants()
ROWS, COLS = _K7["kRows"], _K7["kCols"]  # rows (centres x samples) a K7 block holds; columns a pass
MAX_SCALES, MAX_LAYERS = _K7["kMaxScales"], _K7["kMaxLayers"]
_KC = _K7["kKC"]  # the FMA route's staged weight chunk (input channels)
_MAX_SMEM = _K7["kMaxSmem"]  # bytes of shared memory a block may opt in to
# the wgmma route: column passes a layer, floats a weight stage, stages
TC_PASSES, TC_STAGE, TC_STAGES = _K7["kTcPasses"], _K7["kTcStage"], _K7["kTcStages"]
ROUTES = {"fma": 0, "wgmma": 1}  # the C entry's route argument

Layer = Sequence[torch.Tensor]  # (kernel [ci, co], bias, inv, shift)


def _ceil(x: int, k: int) -> int:
    return -(-x // k) * k


def _tc_stride(cp: int, widths_list: Sequence[Sequence[int]]) -> int:
    """The wgmma route's tile stride in words: at least the gathered row
    (padded to 8 channels) and every layer's passes, and 8 (mod 32), so the
    float2 fragment loads of a half-warp fall in distinct banks."""
    widest = max([_ceil(cp, 8)] + [_ceil(c, COLS) for w in widths_list for c in w])
    return widest + (8 - widest % 32) % 32


def smem_bytes(cp: int, ns_list: Sequence[int], widths_list: Sequence[Sequence[int]],
               route: str = "fma") -> int:
    """K7's shared memory for one launch. FMA: the two row buffers (strides
    padded to odd word counts), the weight chunk and the pooled scales;
    wgmma: the weight ring and its barriers, the one row tile and the pooled
    scales."""
    tm = ROWS // max(ns_list)
    sum_c = sum(w[-1] for w in widths_list)
    if route == "wgmma":  # + a full and an empty barrier (8 bytes each) a stage
        return (4 * (TC_STAGES * TC_STAGE + ROWS * _tc_stride(cp, widths_list)
                     + _ceil(tm * sum_c, 2)) + 16 * TC_STAGES)
    sa, sb = cp, 1
    for widths in widths_list:
        for i, c in enumerate(widths):
            if i % 2 == 0:
                sb = max(sb, c)
            else:
                sa = max(sa, c)
    return 4 * (ROWS * ((sa | 1) + (sb | 1)) + _KC * COLS + tm * sum_c)


def _shape_ok(cp: int, ns_list: Sequence[int], widths_list: Sequence[Sequence[int]]) -> bool:
    return (cp >= 3 and 1 <= len(ns_list) <= MAX_SCALES and len(widths_list) == len(ns_list)
            and all(1 <= ns <= ROWS and ROWS % ns == 0 for ns in ns_list)
            and all(1 <= len(w) <= MAX_LAYERS for w in widths_list))


def sa_fused_route(cp: int, ns_list: Sequence[int], widths_list: Sequence[Sequence[int]]):
    """K7's route for a shape: "wgmma" where every layer is at most
    TC_PASSES x 128 wide and the tile fits, else "fma" where its buffers fit,
    else None (outside the envelope)."""
    if not _shape_ok(cp, ns_list, widths_list):
        return None
    if (all(c <= TC_PASSES * COLS for w in widths_list for c in w)
            and smem_bytes(cp, ns_list, widths_list, "wgmma") <= _MAX_SMEM):
        return "wgmma"
    if smem_bytes(cp, ns_list, widths_list, "fma") <= _MAX_SMEM:
        return "fma"
    return None


def supports(cp: int, ns_list: Sequence[int], widths_list: Sequence[Sequence[int]]) -> bool:
    """K7's envelope: 1 to 4 scales of 1 to 4 layers, each ns a divisor of
    128 (a block holds 128 // max(ns) whole balls), at least the three xyz
    columns, and one route's buffers within the H100's 227 KB of shared
    memory."""
    return sa_fused_route(cp, ns_list, widths_list) is not None


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x (f32) with the low 13 mantissa bits cleared: the TF32 value the
    tensor cores read. 3xTF32 splits x into big = tf32_round(x) and small =
    tf32_round(x - big)."""
    return (x.contiguous().view(torch.int32) & -8192).view(torch.float32)


# within each block of 8 input channels, the order a thread's A fragment
# loads them in: channels 2t and 2t + 1 are the fragment's columns t and t + 4
_FRAGMENT_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


@functools.lru_cache(maxsize=None)
def _stage_map(ci: int, co: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Where each float of a [ci, co] layer's staged weights comes from: an
    index into W.flatten() followed by one zero (the padding), and whether
    the float is the small part. A function of the shape alone."""
    kp, np_ = _ceil(ci, 8), -(-co // COLS)
    kc = TC_STAGE // (2 * np_ * COLS)
    k = torch.arange(kp)
    chan = k // 8 * 8 + torch.tensor(_FRAGMENT_ORDER)[k % 8]  # the channel at fragment slot k
    col = torch.arange(np_ * COLS)
    src = torch.where((chan < ci)[:, None] & (col < co)[None, :], chan[:, None] * co + col,
                      ci * co)  # [kp, n]
    idx, small = [], []
    for k0 in range(0, kp, kc):
        c = src[k0:k0 + kc]
        kcl = c.shape[0]
        c = c.reshape(kcl // 4, 4, np_, COLS // 8, 8).permute(2, 0, 3, 4, 1).reshape(-1)
        idx += [c, c]  # big, then small
        small += [torch.zeros_like(c, dtype=torch.bool), torch.ones_like(c, dtype=torch.bool)]
    return torch.cat(idx).to(device), torch.cat(small).to(device)


def stage_weights(layer: Layer) -> tuple[torch.Tensor, torch.Tensor]:
    """One layer for the wgmma route: (its staged W^T, its epilogue).

    W [ci, co] is padded to [kp, np * 128] (kp: ci rounded up to 8), each
    block of 8 input channels put in `_FRAGMENT_ORDER`, and split into big and
    small (`tf32_round`). The chunks of kc = TC_STAGE / (2 np 128) input
    channels follow each other, each laid out [part (big, small), pass,
    k / 4, n / 8, n % 8, k % 4]: the no-swizzle K-major core matrices (8
    columns x 4 channels) a wgmma descriptor reads, one ring stage a chunk.
    The epilogue is bias, inv and shift, np * 128 each, zero past co."""
    w, bias, inv, shift = (t.detach().float() for t in layer)
    ci, co = w.shape
    idx, small = _stage_map(ci, co, w.device)
    v = torch.cat([w.reshape(-1), w.new_zeros(1)])[idx]
    big = tf32_round(v)
    ep = w.new_zeros(3, -(-co // COLS) * COLS)
    ep[:, :co] = torch.stack([bias, inv, shift])
    return torch.where(small, tf32_round(v - big), big), ep.reshape(-1)


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


@_build.on_input_device
def _sa_fused_cuda(src, idx_list, centers, masks, layers_list, agg_layer, route):
    b, n, cp = src.shape
    m = centers.shape[1]
    entries = [layer for layers in layers_list for layer in layers]
    if agg_layer is not None:
        entries.append(agg_layer)
    parts, off, eoff, ci, co, pos = [], [], [], [], [], 0

    def put(flat: torch.Tensor) -> int:  # 16-byte aligned, for the kernel's vector loads
        nonlocal pos
        at = pos
        parts.append(flat)
        pos += flat.numel()
        if pos % 4:
            parts.append(flat.new_zeros(4 - pos % 4))
            pos = _ceil(pos, 4)
        return at

    for e, (w, bias, inv, shift) in enumerate(entries):
        ci.append(w.shape[0])
        co.append(w.shape[1])
        if route == "wgmma" and e < len(entries) - (agg_layer is not None):
            staged, ep = stage_weights((w, bias, inv, shift))
            off.append(put(staged))
            eoff.append(put(ep))
        else:
            off.append(put(torch.cat([t.detach().float().reshape(-1)
                                      for t in (w, bias, inv, shift)])))
            eoff.append(0)
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
              (ctypes.c_longlong * len(off))(*off), (ctypes.c_longlong * len(eoff))(*eoff)]
    ns_a, nl_a, idx_a, ci_a, co_a, off_a, eoff_a = [ctypes.cast(a, ctypes.c_void_p)
                                                    for a in arrays]
    _build.SA_FUSED(src.data_ptr(), centers.data_ptr(), masks.data_ptr(), params.data_ptr(),
                    out.data_ptr(), b, n, m, cp, r, ns_a, nl_a, idx_a,
                    int(agg_layer is not None), ci_a, co_a, off_a, eoff_a, ROUTES[route],
                    route=route)
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
    if (any(tuple(idx.shape[:2]) != (b, m) for idx in idx_list)
            or masks.shape != (b, m, len(idx_list))):
        raise ValueError("sa_fused_multi: idx, centers and masks disagree on [b, m, R]")
    route = sa_fused_route(src.shape[2], ns_list, widths)
    if route is None:
        raise ValueError(f"sa_fused_multi: outside K7's envelope (cp={src.shape[2]}, "
                         f"ns={ns_list}, widths={widths}); gate the call with supports()")
    with torch.no_grad():
        if _build.require_cuda("sa_fused_multi", src, centers, masks, *idx_list):
            return _sa_fused_cuda(src, idx_list, centers, masks, layers_list, agg_layer, route)
        return sa_fused_multi_plain(src, idx_list, centers, masks, layers_list, agg_layer)


def sa_fused(src: torch.Tensor, idx: torch.Tensor, centers: torch.Tensor, layers) -> torch.Tensor:
    """One scale, unmasked (the JAX package's `sa_fused_pallas`): src [b, n,
    cf + 3]; idx int [b, m, ns]; centers [b, m, 3] -> f32 [b, m, c_out]."""
    ones = torch.ones(idx.shape[0], idx.shape[1], 1, dtype=torch.float32, device=src.device)
    return sa_fused_multi(src, [idx], centers, ones, [layers])
