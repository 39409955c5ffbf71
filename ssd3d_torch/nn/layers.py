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
"""

from __future__ import annotations

import torch
from torch import nn
from torch.distributed.nn.functional import all_reduce as _all_reduce_grad

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
        inv = torch.rsqrt(var + self.epsilon) * self.scale
        return x * inv + (self.bias - mean * inv)


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, b = self.kernel, self.bias
        if self.compute_dtype is not None:
            x, k, b = x.to(self.compute_dtype), k.to(self.compute_dtype), b.to(self.compute_dtype)
        return torch.matmul(x, k) + b


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
        bn = self.bn
        inv = torch.rsqrt(bn.var + bn.epsilon) * bn.scale
        return self.conv.kernel, self.conv.bias, inv, bn.bias - bn.mean * inv

    def forward(self, x: torch.Tensor, bn_momentum: float = 0.9) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x, bn_momentum)
        elif self.gn is not None:
            x = self.gn(x)
        if self.activation:
            x = torch.relu(x)
        return x


class SharedMLP(nn.Module):
    """Stack of PointConv blocks (`conv0`, `conv1`, ...) applied pointwise."""

    def __init__(self, c_in: int, channels, bn: bool = True,
                 compute_dtype: torch.dtype | None = None, use_gn: bool = False):
        super().__init__()
        self.n_layers = len(channels)
        for i, ch in enumerate(channels):
            self.add_module(f"conv{i}", PointConv(c_in, ch, bn=bn, compute_dtype=compute_dtype,
                                                  use_gn=use_gn))
            c_in = ch
        self.out_channels = c_in

    def fold(self) -> list[tuple]:
        """Every layer's `PointConv.fold`, in order."""
        return [getattr(self, f"conv{i}").fold() for i in range(self.n_layers)]

    def forward(self, x: torch.Tensor, bn_momentum: float = 0.9) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"conv{i}")(x, bn_momentum)
        return x
