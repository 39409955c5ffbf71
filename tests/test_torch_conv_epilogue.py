"""The eval-mode PointConv epilogue (K10, `ssd3d_torch/ops/conv_epilogue.py`):
the op against the eager chain it replaced, and which layers take it.

`_eager_chain` writes out what a `SharedMLP` of eval-mode BatchNorm + ReLU
`PointConv`s computed op by op before the op: the product and the bias in
the compute dtype, `.float()`, * inv, + shift, relu, the next layer's cast,
and after the last layer the max over each ball's samples times the
has-points mask. The layers must give it bit for bit, NaN where it has NaN.
Tests marked `cuda` hold kernel K10 to the same chain run on the card and
skip without a GPU.
"""

from __future__ import annotations

from unittest import mock

import numpy as np
import pytest
import torch

from ssd3d_torch.entry import flagship, synthetic_scenes
from ssd3d_torch.nn import layers
from ssd3d_torch.nn.layers import PointConv, SharedMLP
from ssd3d_torch.ops import _build
from ssd3d_torch.ops.conv_epilogue import conv_epilogue, conv_epilogue_plain


def _mlp(c_in, widths, dtype, seed=0, device="cpu", **kw) -> SharedMLP:
    """A SharedMLP in eval mode with seeded weights and BatchNorm statistics
    away from their init values."""
    mlp = SharedMLP(c_in, widths, compute_dtype=dtype, **kw)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in list(mlp.named_parameters()) + list(mlp.named_buffers()):
            if name.endswith("kernel"):
                v = rng.randn(*p.shape) * np.sqrt(2.0 / p.shape[0])
            elif name.endswith(("scale", "var")):
                v = rng.uniform(0.5, 1.5, p.shape)
            else:
                v = rng.randn(*p.shape) * 0.2
            p.copy_(torch.from_numpy(v.astype(np.float32)))
    return mlp.to(device).eval()


def _inputs(shape, seed=1, device="cpu", nan=True):
    """x [b, m, ns, c] (a NaN in one sample of one ball) and has-points int32
    [b, m] with empty balls."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    if nan:
        x[0, -1, shape[2] // 2, 0] = float("nan")
    has = torch.from_numpy((rng.rand(*shape[:2]) > 0.25).astype(np.int32))
    has[0, -2:] = 0  # the NaN ball empty, and one ball beside it
    return x.to(device), has.to(device)


def _eager_chain(mlp: SharedMLP, x, pool=False, has=None):
    """The layers op by op, as they ran before the epilogue op."""
    cd = mlp.compute_dtype
    for i in range(mlp.n_layers):
        conv = getattr(mlp, f"conv{i}")
        k, b = conv.conv.kernel, conv.conv.bias
        if cd is not None:
            x, k, b = x.to(cd), k.to(cd), b.to(cd)
        x = (torch.matmul(x, k) + b).float()
        bn = conv.bn
        inv = torch.rsqrt(bn.var + bn.epsilon) * bn.scale
        x = torch.relu(x * inv + (bn.bias - bn.mean * inv))
    if pool:
        x = x.amax(dim=2)
        if has is not None:
            x = x * has[..., None].to(x.dtype)
    return x


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


_REAL = layers.conv_epilogue


class _Count:
    """Calls of the epilogue op from the layers: (y's shape, y's dtype, pool)."""

    def __init__(self):
        self.calls = []
        self.patch = mock.patch.object(layers, "conv_epilogue", self)

    def __call__(self, y, bias, inv, shift, has_pts, pool, out_dtype):
        self.calls.append((tuple(y.shape), y.dtype, pool))
        return _REAL(y, bias, inv, shift, has_pts, pool, out_dtype)


@pytest.mark.parametrize("pool", [False, True], ids=["rows", "pool"])
@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_layers_through_the_op_equal_the_eager_chain(dtype, pool):
    mlp = _mlp(7, [16, 24, 32], dtype)
    x, has = _inputs((2, 6, 8, 7))
    count = _Count()
    with count.patch, torch.no_grad():
        got = mlp(x, pool=pool, has_pts=has if pool else None)
    assert [c[2] for c in count.calls] == [False, False, pool]  # every layer, the last pools
    assert [c[1] for c in count.calls] == [dtype or torch.float32] * 3
    want = _eager_chain(mlp, x, pool, has if pool else None)
    _same(got, want)
    assert bool(got.isnan().any())
    if pool:
        # without the mask, and the global SSG pool's [b, 1, n, c] view
        with torch.no_grad():
            _same(mlp(x, pool=True), _eager_chain(mlp, x, True))
            flat = x[:, 0]
            _same(mlp(flat[:, None], pool=True)[:, 0], _eager_chain(mlp, flat[:, None], True)[:, 0])
    # with autograd recording, the eager chain itself
    with count.patch:
        eager = mlp(x, pool=pool, has_pts=has if pool else None)
    assert len(count.calls) == 3
    _same(eager.detach(), want)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plain_op_equals_one_eager_layer(out_dtype):
    """One layer's epilogue through the public op (CPU: the plain version),
    written in the next layer's dtype: the eager layer's f32 output cast."""
    mlp = _mlp(5, [12], torch.bfloat16)
    conv = mlp.conv0
    x, _ = _inputs((3, 5, 4, 5))
    y = conv.conv.product(x)
    inv, shift = conv.bn.affine()
    with torch.no_grad():
        got = conv_epilogue(y, conv.conv.bias, inv, shift, None, False, out_dtype)
        want = _eager_chain(mlp, x).to(out_dtype)
    _same(got, want)
    _same(conv_epilogue_plain(y, conv.conv.bias, inv, shift, None, False, out_dtype), want)


def _counted_forward(model, points):
    """The op's calls and the eval BatchNorm + ReLU PointConv calls of one
    inference forward."""
    engaged = []
    hooks = [m.register_forward_pre_hook(lambda m, _a: engaged.append(m))
             for m in model.modules()
             if isinstance(m, PointConv) and m.bn is not None and m.activation]
    count = _Count()
    try:
        with count.patch, torch.inference_mode():
            out = model(points)
    finally:
        for h in hooks:
            h.remove()
    return out, count.calls, engaged


def test_3dssd_eval_forward_takes_the_op_at_every_batchnorm_relu_conv():
    _, model, _, n = flagship(shrink=16, device="cpu")
    model.eval()
    points = torch.from_numpy(synthetic_scenes(2, n)["points"])
    out, calls, engaged = _counted_forward(model, points)
    assert len(engaged) > 20 and len(calls) == len(engaged)
    pools = sum(c[2] for c in calls)
    assert pools == 3 + 3 + 3 + 2  # SA1-SA3's three scales, CG layer4's two
    # the same forward with autograd recording runs the eager chain
    count = _Count()
    with count.patch:
        eager = model(points)
    assert not count.calls
    for key, value in out.items():
        if isinstance(value, torch.Tensor) and value.is_floating_point():
            _same(value, eager[key].detach())


@pytest.mark.parametrize("case", ["train", "groupnorm", "no_bn", "no_relu"])
def test_layers_outside_the_gate_bypass_the_op(case):
    if case == "no_relu":
        conv = PointConv(6, 16, activation=False)
    else:
        conv = PointConv(6, 16, bn=case != "no_bn", use_gn=case == "groupnorm")
    conv.train(case == "train")
    x = torch.randn(2, 4, 8, 6)
    count = _Count()
    with count.patch, torch.no_grad():
        conv(x)
    assert not count.calls


def test_groupnorm_config_forward_bypasses_the_op():
    _, model, _, n = flagship(shrink=16, device="cpu", opts=("MODEL.NETWORK.USE_GN", "True"))
    points = torch.from_numpy(synthetic_scenes(1, n)["points"])
    _, calls, _ = _counted_forward(model.eval(), points)
    assert not calls


# ------------------------------------------------------------------ the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (name, x shape [b, m, ns, c_in], widths, compute dtype, pool): the main
# path's shapes, and row counts and widths off the kernel's vectors and block
CARD_CASES = [
    ("3DSSD SA1 scale 3", (8, 4096, 64, 4), (32, 32, 64), torch.bfloat16, True),
    ("3DSSD SA3 scale 2", (8, 512, 32, 131), (128, 192, 256), torch.bfloat16, True),
    ("3DSSD CG layer4 scale 2", (8, 256, 32, 259), (256, 512, 1024), torch.bfloat16, True),
    ("PointRCNN RPN SA1 scale 1", (4, 4096, 16, 4), (16, 16, 32), None, True),
    ("PointRCNN RPN SA3, 196 wide", (4, 256, 16, 131), (128, 196, 256), None, True),
    ("PointRCNN FP layer", (4, 1, 16384, 384), (128, 128), None, False),
    ("bf16, 196 wide (one element a thread)", (4, 256, 16, 131), (128, 196, 256),
     torch.bfloat16, True),
    ("odd rows", (3, 37, 5, 9), (24, 40, 12), torch.bfloat16, False),
    ("odd rows, pooled", (3, 37, 5, 9), (24, 1040, 12), None, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name, shape, widths, dtype, pool", CARD_CASES,
                         ids=[c[0] for c in CARD_CASES])
def test_kernel_equals_the_eager_chain_on_the_card(cuda, name, shape, widths, dtype, pool):
    mlp = _mlp(shape[-1], list(widths), dtype, device=cuda)
    x, has = _inputs(shape, device=cuda)
    has = has if pool else None
    _build.reset_launches()
    with torch.inference_mode():
        got = mlp(x, pool=pool, has_pts=has)
    torch.cuda.synchronize()
    assert _build.CONV_EPILOGUE.by_route == (
        {"rows": len(widths) - 1, "pool": 1} if pool else {"rows": len(widths)}), name
    assert _build.CONV_EPILOGUE.launches == len(widths)
    with torch.inference_mode():
        want = _eager_chain(mlp, x, pool, has)
    _same(got, want)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    y = torch.zeros(4, 8, 16, device=cuda, dtype=torch.float16)
    v = torch.zeros(16, device=cuda)
    with pytest.raises(ValueError, match="outside K10's envelope"):
        conv_epilogue(y, v, v, v)
    with pytest.raises(ValueError, match="outside K10's envelope"):
        conv_epilogue(y.float().transpose(0, 1), v, v, v)
    with pytest.raises(ValueError, match="outside K10's envelope"):
        conv_epilogue(y.float(), v, v, v, pool=True, out_dtype=torch.bfloat16)
