"""The port's kernels as `torch.library` custom ops (`ssd3d_torch/ops/library.py`):
each op's schema, fake and CPU registration pass `torch.library.opcheck`, the
CUDA registration exists, the public functions equal the plain versions
through the op layer, and the row gather's gradient is still the row
scatter-add. The tests marked `cuda` run opcheck on the CUDA registrations
and skip without a card."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ssd3d_torch.ops import grouping, interpolate, library, sa_fused, sampling

REPO_CSRC = sampling._build.CSRC


def _t(seed, *shape, scale=1.0):
    return torch.from_numpy((np.random.RandomState(seed).randn(*shape) * scale)
                            .astype(np.float32))


def _layers(seed, ci, widths):
    out, rng = [], np.random.RandomState(seed)
    for co in widths:
        out.append(tuple(torch.from_numpy(a.astype(np.float32)) for a in (
            rng.randn(ci, co) * 0.3, rng.randn(co) * 0.1, rng.uniform(0.5, 1.5, co),
            rng.randn(co) * 0.1)))
        ci = co
    return out


def _sa_args(device="cpu"):
    """Two scales of two layers and an aggregation layer over 4 clouds of 24
    points of 5 features (+ xyz), 6 centres each."""
    src = _t(1, 4, 24, 8).to(device)
    idx = [torch.from_numpy(np.random.RandomState(s).randint(0, 24, (4, 6, ns))
                            .astype(np.int32)).to(device) for s, ns in ((2, 4), (3, 8))]
    centers = _t(4, 4, 6, 3).to(device)
    masks = torch.from_numpy(np.random.RandomState(5).randint(0, 2, (4, 6, 2))
                             .astype(np.float32)).to(device)
    scales = [_layers(6, 8, [16, 16]), _layers(7, 8, [16, 32])]
    agg = _layers(8, 48, [24])[0]
    params = [t.to(device) for layer in scales[0] + scales[1] + [agg] for t in layer]
    return src, idx, centers, masks, params, [2, 2], True


def _op_args(device="cpu"):
    """One small input of each op, at shapes of the op's path."""
    xyz = _t(10, 2, 64, 3, scale=2.0).to(device)
    specs = grouping.ring_specs([0.8, 1.6], [8, 16], True)
    pick = torch.from_numpy(np.random.RandomState(11).randint(0, 64, (2, 40))
                            .astype(np.int32)).to(device)
    feats = _t(17, 2, 64, 3).to(device)
    return {
        "fps": (xyz, 16),
        "ffps": (_t(12, 2, 64, 7).to(device), 16),
        "ffps_dist": (sampling.fused_square_distance(_t(13, 2, 32, 4)).to(device), 8),
        "ball_query": (xyz, xyz[:, :12].contiguous(), [s[0] for s in specs],
                       [s[1] for s in specs], [s[2] for s in specs], [s[3] for s in specs]),
        "gather_rows": (_t(14, 2, 64, 5).to(device), pick),
        "scatter_add_rows": (pick, _t(15, 2, 40, 5).to(device), 64),
        "three_nn": (xyz, xyz[:, ::4].contiguous()),
        "sa_fused": _sa_args(device),
        "nms_keep": (torch.from_numpy(np.random.RandomState(16).rand(3, 70, 70) > 0.6).to(device),),
        "ball_query_attention": (xyz, xyz[:, :12].contiguous(), feats, feats[:, :12].contiguous(),
                                 (feats[:, :12] ** 2).sum(-1), (feats ** 2).sum(-1), 0.64, 8),
    }


def test_every_kernel_is_an_op_with_cpu_cuda_and_fake_registrations():
    assert set(library.OPS) == set(_op_args())
    for name, (source, replaced) in library.OPS.items():
        qual = f"ssd3d::{name}"
        assert torch._C._dispatch_has_kernel_for_dispatch_key(qual, "CPU"), name
        assert torch._C._dispatch_has_kernel_for_dispatch_key(qual, "CUDA"), name
        assert torch._C._dispatch_has_kernel_for_dispatch_key(qual, "Meta"), name  # the fake
        head = (REPO_CSRC / source).read_text()[:1500]
        pallas = not any("/" in site.split(":")[0] for site in replaced)
        assert ("ssd3d/ops/pallas/" if pallas else "Replaces no Pallas kernel") in head, source


@pytest.mark.parametrize("name", sorted(library.OPS))
def test_opcheck_cpu_registration_and_fake(name):
    args = _op_args()[name]
    res = torch.library.opcheck(getattr(torch.ops.ssd3d, name).default, args)
    assert set(res.values()) == {"SUCCESS"}, res


@pytest.mark.parametrize("name", sorted(library.OPS))
def test_fake_registration_gives_the_cpu_outputs_shapes(name):
    args = _op_args()[name]
    op = getattr(torch.ops.ssd3d, name).default
    real = op(*args)
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor)
                     else [mode.from_tensor(x) for x in a]
                     if isinstance(a, list) and a and isinstance(a[0], torch.Tensor) else a
                     for a in args]
        fake = op(*fake_args)
    real = real if isinstance(real, tuple) else (real,)
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert [(tuple(r.shape), r.dtype) for r in real] == [(tuple(f.shape), f.dtype) for f in fake]


def test_public_functions_equal_the_plain_versions_through_the_ops():
    a = _op_args()
    xyz, m = a["fps"]
    assert torch.equal(sampling.farthest_point_sample(xyz, m), sampling.fps_plain(xyz, m))
    fused, m2 = a["ffps"]
    assert torch.equal(sampling.farthest_point_sample_features(fused, m2),
                       sampling.ffps_plain(fused, m2))
    dist, m3 = a["ffps_dist"]
    assert torch.equal(sampling.farthest_point_sample_from_dist(dist, m3),
                       sampling.fps_from_dist_plain(dist, m3))
    q = xyz[:, :12].contiguous()
    for dilated in (False, True):
        got = grouping.ball_query_multi([0.8, 1.6, 2.4], [8, 16, 4], xyz, q, dilated=dilated)
        want = grouping.ball_query_multi_plain(
            grouping.ring_specs([0.8, 1.6, 2.4], [8, 16, 4], dilated), xyz, q)
        for (gi, gc), (wi, wc) in zip(got, want, strict=True):
            assert torch.equal(gi, wi) and torch.equal(gc, wc)
    # six rings: two launches of K3 on the card, one op either way
    got = grouping.ball_query_multi([0.4 * k for k in range(1, 7)], [4] * 6, xyz, q)
    want = grouping.ball_query_multi_plain(
        grouping.ring_specs([0.4 * k for k in range(1, 7)], [4] * 6, False), xyz, q)
    assert all(torch.equal(g[0], w[0]) and torch.equal(g[1], w[1]) for g, w in zip(got, want))
    pts, idx = a["gather_rows"]
    assert torch.equal(grouping.gather_rows(pts, idx), grouping.gather_rows_plain(pts, idx))
    assert torch.equal(grouping.gather_rows(pts.to(torch.int32), idx),
                       grouping.gather_rows_plain(pts.to(torch.int32), idx))
    sidx, g, n = a["scatter_add_rows"]
    assert torch.equal(grouping.scatter_add_rows(sidx, g, n),
                       grouping.scatter_add_rows_plain(sidx, g, n))
    k1, k2 = a["three_nn"]
    for got_t, want_t in zip(interpolate.three_nn(k1, k2), interpolate.three_nn_plain(k1, k2)):
        assert torch.equal(got_t, want_t)
    src, idx_l, centers, masks, params, n_layers, _ = _sa_args()
    quads = [tuple(params[i:i + 4]) for i in range(0, len(params), 4)]
    layers_list = [quads[0:2], quads[2:4]]
    assert torch.equal(sa_fused.sa_fused_multi(src, idx_l, centers, masks, layers_list, quads[4]),
                       sa_fused.sa_fused_multi_plain(src, idx_l, centers, masks, layers_list,
                                                     quads[4]))
    assert torch.equal(sa_fused.sa_fused_multi(src, idx_l, centers, masks, layers_list),
                       sa_fused.sa_fused_multi_plain(src, idx_l, centers, masks, layers_list))


def test_ops_refuse_tensors_on_two_devices():
    xyz = torch.zeros(1, 8, 3)
    with pytest.raises(ValueError, match="must all be on CUDA or all on CPU"):
        grouping.ball_query_multi([1.0], [4], xyz, xyz.to("meta"))


def test_gather_rows_gradient_is_the_row_scatter_add():
    pts, idx = _op_args()["gather_rows"]
    idx = torch.cat([idx, idx[:, :7]], 1)  # duplicate rows accumulate
    g = _t(16, *idx.shape, pts.shape[2])
    x = pts.clone().requires_grad_(True)
    out = grouping.gather_rows(x, idx)
    assert torch.equal(out.detach(), grouping.gather_rows_plain(pts, idx))
    out.backward(g)
    assert torch.equal(x.grad, grouping.scatter_add_rows_plain(idx, g, pts.shape[1]))
    # and through group_points, the modules' entry
    y = pts.clone().requires_grad_(True)
    grouping.group_points(y, idx.reshape(2, 47, 1)).sum().backward()
    want = grouping.scatter_add_rows_plain(idx, torch.ones_like(g), pts.shape[1])
    assert torch.equal(y.grad, want)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(library.OPS))
def test_opcheck_cuda_registration(cuda, name):
    args = _op_args(cuda)[name]
    res = torch.library.opcheck(getattr(torch.ops.ssd3d, name).default, args)
    assert set(res.values()) == {"SUCCESS"}, res
