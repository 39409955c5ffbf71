"""Parity of the PyTorch port's point ops with the JAX package.

Every input is made with numpy from a seed and handed to both packages. The
JAX side runs its CPU path (the Pallas kernels are TPU-only); the port runs
its plain PyTorch versions, which is what a CPU tensor dispatches to. Tests
marked `cuda` compare each CUDA kernel with its plain version and skip
without a GPU.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd3d.ops import grouping as jgrouping
from ssd3d.ops import nms as jnms
from ssd3d.ops import sampling as jsampling
from ssd3d_torch.ops import _build
from ssd3d_torch.ops import grouping, nms, sampling

# Relative shortfall allowed for an F-FPS pick below the step's maximum:
# float32 distance sums rounded in another order differ by ~1e-7 relative.
FFPS_TIE_RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _cloud(seed, b, n, scale=5.0):
    return (np.random.RandomState(seed).randn(b, n, 3) * scale).astype(np.float32)


# ------------------------------------------------------------------ D-FPS

@pytest.mark.parametrize("kind", ["gaussian", "grid_ties", "duplicates"])
def test_dfps_matches_jax(kind):
    rng = np.random.RandomState(1)
    if kind == "gaussian":
        xyz = _cloud(1, 2, 1000)
    elif kind == "grid_ties":
        # integer lattice: many exactly equal distances exercise the
        # lowest-index tie rule
        xyz = rng.randint(-6, 7, size=(2, 700, 3)).astype(np.float32)
    else:
        base = _cloud(2, 2, 300)
        xyz = np.concatenate([base, base[:, ::-1]], axis=1)
    m = 128
    want = np.asarray(jsampling.farthest_point_sample(jnp.asarray(xyz), m))
    got = sampling.farthest_point_sample(_t(xyz), m)
    assert got.dtype == torch.int32 and got.shape == (2, m)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fps_route_follows_the_shape(monkeypatch):
    # a few clouds spread over clusters: 3DSSD's SA1-SA3 at batch 8, the
    # RPN's SA1-SA4 at batch 4 and 1, and the RPN's SA1 at batch 16
    for b in (1, 2, 4, 8, 16):
        assert sampling.fps_route(b) == "cluster"
    # many clouds keep one block each: the RCNN's 400 at batch 4, 100 at batch 1
    for b in (17, 100, 400):
        assert sampling.fps_route(b) == "block"
    monkeypatch.setattr(sampling, "fps_route", lambda b: "warp")
    with pytest.raises(ValueError, match="unknown route"):
        sampling._fps_cuda(torch.zeros(1, 8, 3), 4)


def _fps_key(d, i):
    """K1's cluster-route key (csrc/fps.cu `fps_key`) in numpy: the f32
    distance's bits over 0xFFFFFFFF - index."""
    bits = np.asarray(d, np.float32).view(np.uint32).astype(np.uint64)
    return (bits << np.uint64(32)) | (np.uint64(0xFFFFFFFF) - np.asarray(i, np.uint64))


def _better(a, b):
    """csrc/common.cuh `better`: larger distance, then smaller index."""
    return a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])


def test_fps_key_orders_candidates_as_the_tie_rule():
    rng = np.random.RandomState(21)
    tiny = np.float32(1e-45)  # the smallest subnormal
    d = np.concatenate([np.array([0.0, 0.0, tiny, 1.0, 1.0, np.nextafter(np.float32(1), 2),
                                  3.4e38, np.inf, np.inf], np.float32),
                        rng.choice(np.float32([0.0, 0.25, 2.0, 7.5]), 40)])
    i = np.concatenate([[5, 0, 3, 7, 2, 7, 1, 9, 16383], rng.randint(0, 16384, 40)])
    cands = [(np.float32(a), int(b)) for a, b in zip(d, i)]
    keys = _fps_key(d, i)
    for ka, a in zip(keys, cands):
        for kb, b in zip(keys, cands):
            if a != b:
                assert (ka > kb) == _better(a, b), (a, b)
    assert (keys > 0).all()  # a padding slot (key 0) loses to every point
    # the largest key of a distance field is its argmax, first index on ties
    dist = rng.choice(np.float32([0.0, 1.0, 4.0]), size=(6, 500))
    top = _fps_key(dist, np.arange(500)).max(1)
    np.testing.assert_array_equal(0xFFFFFFFF - (top & np.uint64(0xFFFFFFFF)),
                                  torch.from_numpy(dist).argmax(1).numpy())


# ------------------------------------------------------------------ F-FPS

@pytest.mark.parametrize("n,c,m", [(512, 67, 96), (300, 131, 64)])
def test_ffps_tie_aware_against_jax(n, c, m, record_property):
    rng = np.random.RandomState(3)
    fused = np.concatenate(
        [_cloud(4, 2, n), rng.randn(2, n, c - 3).astype(np.float32)], axis=-1)
    want = np.asarray(jsampling.farthest_point_sample_features(jnp.asarray(fused), m))
    got = sampling.farthest_point_sample_features(_t(fused), m)
    assert got.dtype == torch.int32 and got.shape == (2, m)
    assert (got[:, 0] == 0).all()
    # the port takes exact differences, the JAX CPU path a^2 + b^2 - 2ab:
    # both must pick a farthest point at every step, up to rounding
    assert sampling.fps_pick_shortfall(_t(fused), got) <= FFPS_TIE_RTOL
    assert sampling.fps_pick_shortfall(_t(fused), _t(want)) <= FFPS_TIE_RTOL
    equal = int((got.numpy() == want).sum())
    record_property("ffps_equal_picks", f"{equal}/{want.size}")
    assert len(set(got[0].tolist())) == m  # no duplicate picks


def test_ffps_plain_matches_distance_matrix_recurrence():
    fused = _t(np.random.RandomState(5).randn(2, 200, 9).astype(np.float32))
    d = sampling.fused_square_distance(fused)
    np.testing.assert_array_equal(
        sampling.ffps_plain(fused, 50).numpy(),
        sampling.fps_from_dist_plain(d, 50).numpy())


def test_fps_pick_shortfall_flags_a_wrong_pick():
    fused = _t(_cloud(6, 1, 100))
    picks = sampling.fps_plain(fused, 20)
    assert sampling.fps_pick_shortfall(fused, picks) == 0.0
    bad = picks.clone()
    bad[0, 5] = bad[0, 4]  # a point already picked has distance 0
    assert sampling.fps_pick_shortfall(fused, bad) == 1.0


# -------------------------------------------------------------- ball query

def _queries(xyz, m, seed):
    """Queries that hit every case: exact copies of points (d2 == 0), points
    jittered near them, and far-away queries whose balls are empty."""
    rng = np.random.RandomState(seed)
    b, n, _ = xyz.shape
    sel = rng.randint(0, n, size=(b, m))
    q = np.take_along_axis(xyz, sel[..., None], axis=1).copy()
    q[:, 1::3] += rng.randn(b, len(range(1, m, 3)), 3).astype(np.float32) * 0.3
    q[:, 2::7] += 1000.0
    return q.astype(np.float32)


@pytest.mark.parametrize("dilated", [True, False])
@pytest.mark.parametrize("n,m,radii,ns", [
    (1000, 300, [0.5, 1.0, 2.0], [32, 32, 64]),   # SA1-like rings
    (512, 256, [4.8, 6.4], [16, 32]),              # CG-SA-like
    (20, 40, [1.0, 3.0], [32, 8]),                 # ns > n
])
def test_ball_query_multi_matches_jax(n, m, radii, ns, dilated):
    xyz = _cloud(7, 2, n, scale=2.0)
    q = _queries(xyz, m, 8)
    want = jgrouping.ball_query_multi(radii, ns, jnp.asarray(xyz), jnp.asarray(q),
                                      dilated=dilated)
    got = grouping.ball_query_multi(radii, ns, _t(xyz), _t(q), dilated=dilated)
    assert len(got) == len(radii)
    saw_empty = False
    for (gi, gc), (wi, wc), k in zip(got, want, ns):
        assert gi.dtype == torch.int32 and gi.shape == (2, m, k)
        assert gc.dtype == torch.int32 and gc.shape == (2, m)
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        empty = gc.numpy() == 0
        saw_empty |= bool(empty.any())
        assert (gi.numpy()[empty] == 0).all()
    assert saw_empty


def test_ball_query_ring_boundaries_are_half_open():
    # points at exactly r_lo and r_hi along x from the query (exact in f32)
    xyz = np.zeros((1, 5, 3), np.float32)
    xyz[0, :, 0] = [0.0, 0.5, 1.0, 2.0, 3.0]
    q = np.zeros((1, 1, 3), np.float32)
    (i0, c0), (i1, c1) = grouping.ball_query_multi(
        [1.0, 2.0], [4, 4], _t(xyz), _t(q), dilated=True)
    assert c0.item() == 2 and i0[0, 0].tolist() == [0, 1, 0, 0]
    # annulus 1 <= d < 2 plus the d == 0 self point
    assert c1.item() == 2 and i1[0, 0].tolist() == [0, 2, 0, 0]


def test_group_points_matches_jax():
    rng = np.random.RandomState(9)
    for c in (4, 67, 131, 259):
        pts = rng.randn(2, 50, c).astype(np.float32)
        idx = rng.randint(0, 50, size=(2, 12, 5)).astype(np.int32)
        want = np.asarray(jgrouping.group_points(jnp.asarray(pts), jnp.asarray(idx)))
        got = grouping.group_points(_t(pts), _t(idx))
        assert got.shape == (2, 12, 5, c)
        np.testing.assert_array_equal(got.numpy(), want)
    ints = rng.randint(-2**31, 2**31 - 1, size=(1, 30, 3)).astype(np.int32)
    idx = rng.randint(0, 30, size=(1, 4, 6)).astype(np.int32)
    np.testing.assert_array_equal(
        grouping.group_points(_t(ints), _t(idx)).numpy(),
        np.asarray(jgrouping.group_points(jnp.asarray(ints), jnp.asarray(idx))))


# --------------------------------------------------------------------- NMS

def _bev_boxes(seed, k):
    rng = np.random.RandomState(seed)
    ctr = rng.uniform(0, 12, size=(k, 2))
    half = rng.uniform(0.5, 2.5, size=(k, 2))
    boxes = np.concatenate([ctr - half, ctr + half], axis=-1).astype(np.float32)
    # repeated scores check the stable order of equal scores
    scores = rng.choice(np.linspace(0.05, 0.95, 12), size=k).astype(np.float32)
    return boxes, scores


@pytest.mark.parametrize("k,max_output,thr", [(80, 100, 0.1), (120, 30, 0.3), (64, 64, 0.0)])
def test_nms_bev_matches_jax(k, max_output, thr):
    boxes, scores = _bev_boxes(10 + k, k)
    wi, wv = jnms.nms_bev(jnp.asarray(boxes), jnp.asarray(scores), max_output, thr)
    gi, gv = nms.nms_bev(_t(boxes), _t(scores), max_output, thr)
    assert gi.dtype == torch.int32 and gv.dtype == torch.bool
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


@pytest.mark.parametrize("reg_cls", [1, 2])
def test_batched_class_nms_matches_jax(reg_cls):
    rng = np.random.RandomState(11)
    b, n, cls = 2, 90, 2
    boxes3d = rng.uniform(-10, 10, size=(b, n, reg_cls, 7)).astype(np.float32)
    bev = np.stack([_bev_boxes(20 + i * reg_cls + j, n)[0]
                    for i in range(b) for j in range(reg_cls)])
    bev = bev.reshape(b, reg_cls, n, 4).transpose(0, 2, 1, 3).copy()
    scores = rng.choice(np.linspace(0.1, 0.9, 9), size=(b, n, cls)).astype(np.float32)
    want = jnms.batched_class_nms(jnp.asarray(boxes3d), jnp.asarray(bev),
                                  jnp.asarray(scores), 40, 0.1)
    got = nms.batched_class_nms(_t(boxes3d), _t(bev), _t(scores), 40, 0.1)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)


# ---------------------------------------------------------------- dispatch

def test_cpu_tensors_take_the_plain_versions():
    _build.reset_launches()
    xyz = _t(_cloud(12, 1, 64))
    sampling.farthest_point_sample(xyz, 8)
    sampling.farthest_point_sample_features(torch.cat([xyz, xyz], -1), 8)
    (idx, _), = grouping.ball_query_multi([1.0], [4], xyz, xyz[:, :5])
    src = xyz.clone().requires_grad_(True)
    grouping.group_points(src, idx).sum().backward()  # the scatter-add backward
    assert src.grad.shape == xyz.shape
    assert _build.launches() == {"fps": 0, "ffps": 0, "ball_query": 0, "gather": 0,
                                 "scatter_add": 0, "three_nn": 0, "sa_fused": 0}
    assert _build._lib is None  # nothing was built or loaded


def test_other_devices_raise_instead_of_falling_back():
    xyz = torch.zeros(1, 16, 3, device="meta")
    with pytest.raises(ValueError, match="CUDA or all on CPU"):
        sampling.farthest_point_sample(xyz, 4)
    with pytest.raises(ValueError, match="CUDA or all on CPU"):
        grouping.ball_query_multi([1.0], [4], torch.zeros(1, 16, 3), xyz)


def test_build_without_nvcc_raises_a_clear_error(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc was not found"):
        _build.build()
    assert not (tmp_path / "build").exists()


# -------------------------------------------------- kernels (need the card)

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("route", [None, "block", "cluster"])
@pytest.mark.parametrize("n,m", [(16384, 512), (1000, 200), (4096, 512)])
def test_fps_kernel_equals_plain(cuda, n, m, route, monkeypatch):
    if route is not None:
        monkeypatch.setattr(sampling, "fps_route", lambda b: route)
    xyz = _t(_cloud(13, 3, n, scale=20.0))
    _build.reset_launches()
    got = sampling.farthest_point_sample(xyz.to(cuda), m)
    np.testing.assert_array_equal(got.cpu().numpy(), sampling.fps_plain(xyz, m).numpy())
    assert _build.route_launches()["fps"] == {route or "cluster": 1}


def _fps_cloud(kind, b, n):
    rng = np.random.RandomState(22)
    if kind == "gaussian":
        return _cloud(23, b, n, scale=20.0)
    if kind == "grid_ties":  # integer lattice: equal distances everywhere
        return rng.randint(-6, 7, size=(b, n, 3)).astype(np.float32)
    half = _cloud(24, b, (n + 1) // 2)  # every point twice
    return np.concatenate([half, half[:, ::-1]], axis=1)[:, :n].copy()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gaussian", "grid_ties", "duplicates"])
@pytest.mark.parametrize("b", [1, 2, 8])
@pytest.mark.parametrize("n", [16384, 16383, 4096, 1000])
def test_fps_cluster_route_equals_plain(cuda, n, b, kind):
    """Ties across CTAs and warps, a partial last slice (16,383, 1,000) and
    the cluster sizes the occupancy query gives at 1, 2 and 8 clouds."""
    xyz = _t(_fps_cloud(kind, b, n)).to(cuda)
    m = 4096 if (n, b, kind) == (16384, 8, "gaussian") else 512  # the flagship's SA1
    _build.reset_launches()
    got = sampling.farthest_point_sample(xyz, m)  # b <= 16: the cluster route
    assert _build.launches()["fps"] == 1
    assert _build.route_launches()["fps"] == {"cluster": 1}
    assert torch.equal(got, sampling.fps_plain(xyz, m))


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,m", [(4096, 67, 128), (512, 131, 256), (777, 10, 100)])
def test_ffps_kernel_tie_aware(cuda, n, c, m):
    fused = _t(np.random.RandomState(14).randn(2, n, c).astype(np.float32)).to(cuda)
    got = sampling.farthest_point_sample_features(fused, m)
    assert (got[:, 0] == 0).all()
    assert sampling.fps_pick_shortfall(fused, got) <= FFPS_TIE_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("dilated", [True, False])
def test_ball_query_kernel_equals_plain(cuda, dilated):
    xyz = _cloud(15, 2, 5000, scale=3.0)
    q = _queries(xyz, 700, 16)
    want = grouping.ball_query_multi([0.2, 0.4, 0.8], [32, 32, 64], _t(xyz), _t(q),
                                     dilated=dilated)
    got = grouping.ball_query_multi([0.2, 0.4, 0.8], [32, 32, 64], _t(xyz).to(cuda),
                                    _t(q).to(cuda), dilated=dilated)
    for (gi, gc), (wi, wc) in zip(got, want):
        np.testing.assert_array_equal(gc.cpu().numpy(), wc.numpy())
        np.testing.assert_array_equal(gi.cpu().numpy(), wi.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 4, 67, 128, 131, 259])
def test_gather_kernel_bit_identical(cuda, c):
    rng = np.random.RandomState(17)
    pts = _t(rng.randn(2, 300, c).astype(np.float32))
    idx = _t(rng.randint(0, 300, size=(2, 64, 16)).astype(np.int32))
    got = grouping.group_points(pts.to(cuda), idx.to(cuda))
    want = grouping.group_points(pts, idx)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    ints = pts.view(torch.int32)  # i32 rows are copied as they are
    assert torch.equal(grouping.group_points(ints.to(cuda), idx.to(cuda)).cpu(),
                       grouping.group_points(ints, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [2, 4, 128])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_gather_kernel_misaligned_source(cuda, c, offset):
    """A contiguous source whose storage offset breaks the 16-byte alignment
    of the vector copies."""
    rng = np.random.RandomState(25)
    flat = _t(rng.randn(2 * 300 * c + offset).astype(np.float32)).to(cuda)
    pts = flat[offset:].view(2, 300, c)
    assert pts.is_contiguous() and pts.data_ptr() % 16 != 0
    idx = _t(rng.randint(0, 300, size=(2, 1000)).astype(np.int32)).to(cuda)
    got = grouping.gather_rows(pts, idx)
    assert torch.equal(got.view(torch.int32), grouping.gather_rows_plain(pts, idx).view(torch.int32))


@pytest.mark.cuda
def test_gather_kernel_clamps_indices_and_takes_zero_rows(cuda):
    rng = np.random.RandomState(26)
    pts = _t(rng.randn(3, 50, 67).astype(np.float32)).to(cuda)
    idx = _t(rng.randint(-40, 90, size=(3, 777)).astype(np.int32)).to(cuda)
    idx[0, :4] = torch.tensor([-2**31, 2**31 - 1, -1, 50], dtype=torch.int32)
    _build.reset_launches()
    got = grouping.gather_rows(pts, idx)
    want = pts.cpu()[torch.arange(3)[:, None], idx.cpu().long().clamp(0, 49)]
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    empty = grouping.gather_rows(pts, idx[:, :0])
    assert empty.shape == (3, 0, 67)
    assert _build.launches()["gather"] == 1  # nothing to launch for zero rows


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 4])
def test_gather_kernel_takes_more_batch_rows_than_a_grid_column(cuda, c):
    """b > 65,535 (the grid's y limit), on the word and the vector route."""
    rng = np.random.RandomState(27)
    b = 65535 + 7
    pts = _t(rng.randn(b, 3, c).astype(np.float32)).to(cuda)
    idx = _t(rng.randint(0, 3, size=(b, 2)).astype(np.int32)).to(cuda)
    got = grouping.gather_rows(pts, idx)
    assert torch.equal(got.view(torch.int32), grouping.gather_rows_plain(pts, idx).view(torch.int32))


@pytest.mark.cuda
def test_gather_kernel_gradient_is_the_scatter_add_kernel(cuda):
    rng = np.random.RandomState(18)
    pts = _t(rng.randn(2, 300, 67).astype(np.float32))
    idx = _t(rng.randint(0, 300, size=(2, 64, 16)).astype(np.int32))
    w = _t(rng.randn(2, 64, 16, 67).astype(np.float32))
    want = pts.clone().requires_grad_(True)
    (grouping.group_points(want, idx) * w).sum().backward()
    got = pts.to(cuda).requires_grad_(True)
    _build.reset_launches()
    (grouping.group_points(got, idx.to(cuda)) * w.to(cuda)).sum().backward()
    assert _build.launches()["gather"] == 1 and _build.launches()["scatter_add"] == 1
    torch.testing.assert_close(got.grad.cpu(), want.grad, rtol=1e-5, atol=1e-5)
    with torch.inference_mode():  # no gradient: the forward kernel alone
        grouping.group_points(got, idx.to(cuda))
    assert _build.launches()["scatter_add"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,rows", [(4096, 67, 65536), (1024, 131, 16384), (512, 259, 8192),
                                      (7, 5, 1000)])
def test_scatter_add_kernel_matches_plain(cuda, n, c, rows):
    """Within 1e-5 of the largest |entry|: float atomics add in another
    order than the plain version's index_add_."""
    rng = np.random.RandomState(19)
    idx = rng.randint(-2, n + 2, size=(2, rows)).astype(np.int32)  # clamped ends
    idx[:, 1::4] = idx[:, ::4][:, :idx[:, 1::4].shape[1]]  # duplicates
    g = _t(rng.randn(2, rows, c).astype(np.float32))
    want = grouping.scatter_add_rows_plain(_t(idx), g, n)
    got = grouping.scatter_add_rows(_t(idx).to(cuda), g.to(cuda), n)
    err = float((got.cpu() - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err
    with pytest.raises(ValueError, match="f32"):
        grouping.scatter_add_rows(_t(idx).to(cuda), g.to(cuda).double(), n)


@pytest.mark.cuda
def test_kernels_count_their_launches(cuda):
    _build.reset_launches()
    xyz = torch.randn(1, 256, 3, device=cuda)
    sampling.farthest_point_sample(xyz, 8)
    sampling.farthest_point_sample(xyz, 8)
    with pytest.MonkeyPatch.context() as mp:  # both routes are the one kernel's
        mp.setattr(sampling, "fps_route", lambda b: "block")
        sampling.farthest_point_sample(xyz, 8)
    assert _build.launches()["fps"] == 3
    assert _build.route_launches()["fps"] == {"cluster": 2, "block": 1}
    assert os.path.exists(_build.library_path())
