"""Basic layers (counterpart of `ssd3d/nn/layers.py`).

Every "convolution" of this model family is 1x1, a matrix product over the
channel axis, so `PointConv` is a Dense layer (`torch.matmul`) followed by
BatchNorm and ReLU. Parameter names follow the flax scopes (`conv.kernel`
[c_in, c_out], `conv.bias`, `bn.scale`, `bn.bias`, buffers `bn.mean`,
`bn.var`), so a flax variable tree converts by joining its paths.

Train or eval mode is the module's `training` flag; the BatchNorm momentum is
a call argument (`bn_momentum`), passed down as in the JAX signatures,
because the schedule changes it from step to step.
"""

from __future__ import annotations

import torch
from torch import nn


class BatchNorm(nn.Module):
    """Batch normalisation over every axis but the last, with the JAX
    package's epsilon (1e-3) and variable names; always computes in f32.

    Train mode normalises with the batch's mean and biased variance
    (mean(x^2) - mean^2, clamped at 0; the gradient flows through both) and
    updates the running statistics as m * running + (1 - m) * batch. This is
    written out because `F.batch_norm` differs: it takes the inverse
    momentum, keeps the unbiased variance and defaults to another epsilon."""

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
            mean = x.mean(dims)
            var = ((x * x).mean(dims) - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                m = torch.as_tensor(bn_momentum, dtype=torch.float32)  # f32, as in JAX
                self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                self.var.copy_(m * self.var + (1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.epsilon) * self.scale
        return x * inv + (self.bias - mean * inv)


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
    """1x1 conv (Dense) + optional BatchNorm + optional ReLU."""

    def __init__(self, c_in: int, channels: int, bn: bool = True,
                 activation: bool = True, compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.conv = Dense(c_in, channels, compute_dtype)
        self.bn = BatchNorm(channels) if bn else None
        self.activation = activation

    def fold(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """The layer as data for the fused SA kernel: (kernel [c_in, c_out],
        bias, inv, shift), eval-mode BatchNorm reduced to y * inv + shift with
        inv = rsqrt(var + eps) * scale, shift = bias - mean * inv (the
        arithmetic of `BatchNorm.forward` in eval mode)."""
        if self.bn is None or not self.activation or self.training:
            raise ValueError("PointConv.fold: needs BatchNorm, ReLU and eval mode")
        bn = self.bn
        inv = torch.rsqrt(bn.var + bn.epsilon) * bn.scale
        return self.conv.kernel, self.conv.bias, inv, bn.bias - bn.mean * inv

    def forward(self, x: torch.Tensor, bn_momentum: float = 0.9) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x, bn_momentum)
        if self.activation:
            x = torch.relu(x)
        return x


class SharedMLP(nn.Module):
    """Stack of PointConv blocks (`conv0`, `conv1`, ...) applied pointwise."""

    def __init__(self, c_in: int, channels, bn: bool = True,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.n_layers = len(channels)
        for i, ch in enumerate(channels):
            self.add_module(f"conv{i}", PointConv(c_in, ch, bn=bn, compute_dtype=compute_dtype))
            c_in = ch
        self.out_channels = c_in

    def fold(self) -> list[tuple]:
        """Every layer's `PointConv.fold`, in order."""
        return [getattr(self, f"conv{i}").fold() for i in range(self.n_layers)]

    def forward(self, x: torch.Tensor, bn_momentum: float = 0.9) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"conv{i}")(x, bn_momentum)
        return x
