"""The epilogue of an eval-mode PointConv as one op (K10).

What follows the product y = x @ kernel of a `nn.layers.PointConv` with
BatchNorm and ReLU in eval mode: the bias added in the compute dtype, the
folded BatchNorm (y * inv + shift in f32, `BatchNorm.affine`), the ReLU and
the cast to the next layer's compute dtype; with `pool`, the max over axis -2
(each ball's samples) times the scale's has-points mask, so that only the
pooled rows are written. Its custom op `torch.ops.ssd3d.conv_epilogue`
(`ops/library.py`) dispatches on the device: CUDA tensors launch kernel K10
(`csrc/conv_epilogue.cu`), one pass over y, on its "rows" or "pool" route;
CPU tensors take `conv_epilogue_plain`, the eager chain's own arithmetic.
Both round at the same points, so the two agree bit for bit.

The op has no autograd formula: `PointConv` takes it only where no gradient
is recorded.
"""

from __future__ import annotations

import torch

from ssd3d_torch.ops import _build

DTYPES = (torch.float32, torch.bfloat16)  # y's dtypes (the compute dtype)


def out_shape(y: torch.Tensor, pool: bool) -> tuple:
    return tuple(y.shape[:-2]) + (y.shape[-1],) if pool else tuple(y.shape)


def conv_epilogue_plain(y: torch.Tensor, bias: torch.Tensor, inv: torch.Tensor,
                        shift: torch.Tensor, has_pts: torch.Tensor | None, pool: bool,
                        out_dtype: torch.dtype) -> torch.Tensor:
    """relu(f32(y + bias in y's dtype) * inv + shift), as `Dense`,
    `BatchNorm` and `torch.relu` compute it; with `pool`, its max over axis
    -2 times has_pts (int [...], 0 or 1) where given, f32 [..., c]; else
    cast to out_dtype."""
    x = torch.relu((y + bias.to(y.dtype)).float() * inv + shift)
    if not pool:
        return x.to(out_dtype)
    x = x.amax(dim=-2)
    return x if has_pts is None else x * has_pts[..., None].to(x.dtype)


def _check(y, bias, inv, shift, has_pts, pool, out_dtype) -> None:
    """The kernel's envelope: y f32 or bf16, contiguous, at least [rows, c]
    (pool: [..., ns, c]); bias, inv and shift f32 [c], contiguous; has_pts
    int32 of y's shape but the last two axes, only with pool; out_dtype f32
    or y's dtype, f32 when pooling; every tensor on y's card. One pass over
    the conditions (the op runs once a layer); the message is built only on
    failure."""
    dev, c = y.device, (y.shape[-1] if y.dim() else 0)
    params = (bias, inv, shift) + (() if has_pts is None else (has_pts,))
    if (y.dtype in DTYPES and y.dim() >= (2 if pool else 1) and y.is_contiguous()
            and all(t.device == dev and t.is_contiguous() for t in params)
            and all(t.dtype == torch.float32 and t.shape == (c,) for t in (bias, inv, shift))
            and (out_dtype == torch.float32 or (out_dtype == y.dtype and not pool))
            and (has_pts is None or (pool and has_pts.dtype == torch.int32
                                     and has_pts.shape == y.shape[:-2]))):
        return
    raise ValueError(
        "conv_epilogue: outside K10's envelope: y contiguous f32 or bf16 [..., c] on the card, "
        "bias / inv / shift contiguous f32 [c], has_pts contiguous int32 [...] with pool, "
        "out_dtype f32 or y's dtype (f32 when pooling); got y "
        f"{y.dtype} {tuple(y.shape)} on {dev}, "
        + ", ".join(f"{t.dtype} {tuple(t.shape)} on {t.device}" for t in params)
        + f", pool {pool}, out_dtype {out_dtype}")


@_build.on_input_device
def _conv_epilogue_cuda(y, bias, inv, shift, has_pts, pool, out_dtype) -> torch.Tensor:
    _check(y, bias, inv, shift, has_pts, pool, out_dtype)
    out = torch.empty(out_shape(y, pool), dtype=out_dtype, device=y.device)
    if out.numel():
        c = y.shape[-1]
        _build.CONV_EPILOGUE(
            y.data_ptr(), bias.data_ptr(), inv.data_ptr(), shift.data_ptr(),
            has_pts.data_ptr() if has_pts is not None else None, out.data_ptr(),
            y.numel() // c, y.shape[-2] if pool else 0, c, int(y.dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16), _build.sm_count(),
            route="pool" if pool else "rows")
    return out


def conv_epilogue(y: torch.Tensor, bias: torch.Tensor, inv: torch.Tensor, shift: torch.Tensor,
                  has_pts: torch.Tensor | None = None, pool: bool = False,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The epilogue (`torch.ops.ssd3d.conv_epilogue`): K10 on CUDA tensors,
    `conv_epilogue_plain` on CPU tensors. The dispatcher sends any mix with
    a CUDA tensor to the kernel's wrapper, whose envelope check refuses it."""
    return torch.ops.ssd3d.conv_epilogue(y, bias, inv, shift, has_pts, pool, out_dtype)
