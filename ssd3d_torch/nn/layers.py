"""Basic layers (counterpart of `ssd3d/nn/layers.py`).

Every "convolution" of this model family is 1x1, a matrix product over the
channel axis, so `PointConv` is a Dense layer (`torch.matmul`) followed by
BatchNorm (or GroupNorm, MODEL.NETWORK.USE_GN) and ReLU. Parameter names
follow the flax scopes (`conv.kernel` [c_in, c_out], `conv.bias`,
`bn.scale`, `bn.bias`, buffers `bn.mean`, `bn.var`; `gn.scale`,
`gn.bias`), so a flax variable tree converts by joining its paths.

Under a process group of more than one rank (`torch.distributed`, one rank a
card), train-mode BatchNorm takes the statistics of the global batch, as
the JAX package's BatchNorm does over its mesh-sharded batch.

Train or eval mode is the module's `training` flag; the BatchNorm momentum is
a call argument (`bn_momentum`), passed down as in the JAX signatures,
because the schedule changes it from step to step.

In eval mode a `PointConv` with BatchNorm and ReLU runs what follows its
product (the bias, the folded BatchNorm, the ReLU, the cast, and where asked
the max-pool over a ball's samples) as one op, `ops.conv_epilogue` (K10 on
the card), with the eager chain's rounding; in train mode, under GroupNorm,
without BatchNorm or ReLU, and wherever autograd records, the chain runs op
by op.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.distributed.nn.functional import all_reduce as _all_reduce_grad

from ssd3d_torch.ops.conv_epilogue import DTYPES as EPILOGUE_DTYPES, conv_epilogue
from ssd3d_torch.parallel.distributed import world


def _global_moments(x: torch.Tensor, dims: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """mean and E[x^2] over `dims` of the batch of every rank: each rank's
    sums with its element count, all-reduced (with their gradient, which
    sums the ranks' gradients back onto each rank's x)."""
    count = x.new_tensor(float(x.numel() // x.shape[-1]))
    local = torch.cat([x.sum(dims), (x * x).sum(dims), count[None]])
    total = _all_reduce_grad(local)
    c = x.shape[-1]
    n = total[2 * c:].detach()
    return total[:c] / n, total[c:2 * c] / n


class BatchNorm(nn.Module):
    """Batch normalisation over every axis but the last, with the JAX
    package's epsilon (1e-3) and variable names; always computes in f32.

    Train mode normalises with the batch's mean and biased variance
    (mean(x^2) - mean^2, clamped at 0; the gradient flows through both) and
    updates the running statistics as m * running + (1 - m) * batch. This is
    written out because `F.batch_norm` differs: it takes the inverse
    momentum, keeps the unbiased variance and defaults to another epsilon.
    Under a process group of more than one rank the mean and E[x^2] are
    those of every rank's batch (`_global_moments`); with one rank the
    arithmetic is the single-process one."""

    def __init__(self, channels: int, epsilon: float = 1e-3):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor, bn_momentum: float = 0.9) -> torch.Tensor:
        x = x.float()
        if self.training:
            dims = tuple(range(x.dim() - 1))
            if world() > 1:
                mean, mean2 = _global_moments(x, dims)
            else:
                mean, mean2 = x.mean(dims), (x * x).mean(dims)
            var = (mean2 - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                m = torch.as_tensor(bn_momentum, dtype=torch.float32)  # f32, as in JAX
                self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                self.var.copy_(m * self.var + (1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        inv, shift = self.affine(mean, var)
        return x * inv + shift

    def affine(self, mean: torch.Tensor | None = None,
               var: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """(inv, shift) of x * inv + shift: inv = rsqrt(var + eps) * scale,
        shift = bias - mean * inv; by default of the running statistics
        (eval mode)."""
        mean = self.mean if mean is None else mean
        var = self.var if var is None else var
        inv = torch.rsqrt(var + self.epsilon) * self.scale
        return inv, self.bias - mean * inv


class GroupNorm(nn.Module):
    """flax.linen.GroupNorm(num_groups=min(32, channels)) under flax 0.12's
    defaults, channels last: epsilon 1e-6; the statistics of f32 values over
    every axis but axis 0 (the scan, or the RoI where a backbone runs on RoI
    clouds) and over each group's channels (`moments`), the variance as
    E[x^2] - E[x]^2 clamped at 0; then (x - mean) * (rsqrt(var + eps) *
    scale) + bias, in f32. The reduction is written out on a [b, rest,
    groups, channels / groups] view (`F.group_norm` wants the channels at
    axis 1). No running statistics: train and eval mode compute alike."""

    def __init__(self, channels: int, epsilon: float = 1e-6):
        super().__init__()
        self.groups = min(32, channels)
        if channels % self.groups:
            raise ValueError(f"GroupNorm: {self.groups} groups do not divide {channels} channels")
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def moments(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x f32 [b, ..., c] -> (E[x], E[x^2]) of each (row of axis 0, group):
        [b, groups] each, summed in float64 and rounded to f32 once. The
        reduced axes (the rows and the group's channels) are not adjacent,
        and an f32 mean over them accumulates row by row on the CPU: 1.5e-5
        off at 524,288 values (the flagship's SA1), which the one-pass
        variance then multiplies where a group's values are nearly equal."""
        g = x.reshape(x.shape[0], -1, self.groups, x.shape[-1] // self.groups)
        n = g.shape[1] * g.shape[3]
        return ((g.sum((1, 3), dtype=torch.float64) / n).float(),
                ((g * g).sum((1, 3), dtype=torch.float64) / n).float())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        c = x.shape[-1]
        mean, mean2 = self.moments(x)
        var = (mean2 - mean * mean).clamp(min=0.0)
        shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (c,)
        mean = mean.repeat_interleave(c // self.groups, -1).reshape(shape)
        var = var.repeat_interleave(c // self.groups, -1).reshape(shape)
        return (x - mean) * (torch.rsqrt(var + self.epsilon) * self.scale) + self.bias


class Dense(nn.Module):
    """y = x @ kernel + bias, kernel [c_in, c_out] as in flax. With a
    compute dtype, x, kernel and bias are cast to it before the product and
    the bias is added in it (nn.Dense's promotion)."""

    def __init__(self, c_in: int, c_out: int, compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.kernel = nn.Parameter(torch.empty(c_in, c_out))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def product(self, x: torch.Tensor) -> torch.Tensor:
        """x @ kernel, both cast to the compute dtype where one is set."""
        if self.compute_dtype is not None:
            return torch.matmul(x.to(self.compute_dtype), self.kernel.to(self.compute_dtype))
        return torch.matmul(x, self.kernel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.product(x)
        return y + self.bias.to(y.dtype)


class PointConv(nn.Module):
    """1x1 conv (Dense) + optional BatchNorm, or GroupNorm where `use_gn`
    (the module `gn`, in place of `bn`), + optional ReLU."""

    def __init__(self, c_in: int, channels: int, bn: bool = True,
                 activation: bool = True, compute_dtype: torch.dtype | None = None,
                 use_gn: bool = False):
        super().__init__()
        self.conv = Dense(c_in, channels, compute_dtype)
        self.bn = BatchNorm(channels) if bn and not use_gn else None
        self.gn = GroupNorm(channels) if bn and use_gn else None
        self.activation = activation

    def fold(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """The layer as data for the fused SA kernel: (kernel [c_in, c_out],
        bias, inv, shift), eval-mode BatchNorm reduced to y * inv + shift with
        inv = rsqrt(var + eps) * scale, shift = bias - mean * inv (the
        arithmetic of `BatchNorm.forward` in eval mode)."""
        if self.gn is not None:
            raise ValueError("PointConv.fold: GroupNorm normalises by its input's statistics "
                             "and does not fold")
        if self.bn is None or not self.activation or self.training:
            raise ValueError("PointConv.fold: needs BatchNorm, ReLU and eval mode")
        return (self.conv.kernel, self.conv.bias) + self.bn.affine()

    def takes_epilogue(self, x: torch.Tensor) -> bool:
        """Whether the layer runs its epilogue as one `conv_epilogue` op:
        where `fold` succeeds (eval mode, BatchNorm, ReLU), the product in
        f32 or bf16, and no gradient recorded (the op has no autograd
        formula)."""
        return (self.bn is not None and self.activation and not self.training
                and (self.conv.compute_dtype or x.dtype) in EPILOGUE_DTYPES
                and not (torch.is_grad_enabled()
                         and (x.requires_grad or any(p.requires_grad for p in self.parameters()))))

    def forward(self, x: torch.Tensor, bn_momentum: float = 0.9, pool: bool = False,
                has_pts: torch.Tensor | None = None,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """x [..., c_in] -> [..., channels], f32 or, where the epilogue op
        writes it, `out_dtype` (the next layer's compute dtype, which that
        layer would cast it to). With `pool`, the output's `max_pool` over
        axis 2 of [b, m, ns, c] (each ball's samples) times has_pts (int
        [b, m], 0 or 1) where given -> [b, m, channels] f32."""
        if self.takes_epilogue(x):
            return conv_epilogue(self.conv.product(x), self.conv.bias, *self.bn.affine(),
                                 has_pts, pool, torch.float32 if pool else out_dtype)
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x, bn_momentum)
        elif self.gn is not None:
            x = self.gn(x)
        if self.activation:
            x = torch.relu(x)
        if pool:
            x = max_pool(x)
            if has_pts is not None:
                x = x * has_pts[..., None].to(x.dtype)
        return x


class SharedMLP(nn.Module):
    """Stack of PointConv blocks (`conv0`, `conv1`, ...) applied pointwise."""

    def __init__(self, c_in: int, channels, bn: bool = True,
                 compute_dtype: torch.dtype | None = None, use_gn: bool = False):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.n_layers = len(channels)
        for i, ch in enumerate(channels):
            self.add_module(f"conv{i}", PointConv(c_in, ch, bn=bn, compute_dtype=compute_dtype,
                                                  use_gn=use_gn))
            c_in = ch
        self.out_channels = c_in

    def fold(self) -> list[tuple]:
        """Every layer's `PointConv.fold`, in order."""
        return [getattr(self, f"conv{i}").fold() for i in range(self.n_layers)]

    def forward(self, x: torch.Tensor, bn_momentum: float = 0.9, pool: bool = False,
                has_pts: torch.Tensor | None = None) -> torch.Tensor:
        """x [..., c_in] -> [..., out_channels] f32; with `pool`, the last
        layer's output max-pooled over each ball's samples, times has_pts
        where given (`PointConv.forward`): [b, m, ns, c_in] -> [b, m, c]."""
        inner = self.compute_dtype or torch.float32
        for i in range(self.n_layers):
            if i < self.n_layers - 1:
                x = getattr(self, f"conv{i}")(x, bn_momentum, out_dtype=inner)
            else:
                x = getattr(self, f"conv{i}")(x, bn_momentum, pool, has_pts)
        return x


def max_pool(grouped: torch.Tensor) -> torch.Tensor:
    """Max over each ball's samples: [b, m, ns, c] -> [b, m, c]. `amax`
    splits the gradient evenly among tied maxima, as JAX's max does (padding
    repeats the first hit; ReLU outputs zeros); `max(dim).values` would send
    it all to one sample."""
    return grouped.amax(dim=2)
