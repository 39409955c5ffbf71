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

@pytest.mark.parametrize("kind", ["gaussian", "grid_ties", "duplicates", "voxel_lattice"])
def test_dfps_matches_jax(kind):
    rng = np.random.RandomState(1)
    if kind == "gaussian":
        xyz = _cloud(1, 2, 1000)
    elif kind == "grid_ties":
        # integer lattice: many exactly equal distances exercise the
        # lowest-index tie rule
        xyz = rng.randint(-6, 7, size=(2, 700, 3)).astype(np.float32)
    elif kind == "voxel_lattice":
        # STD's voxel centres, (i + 0.5) / 8 - 0.5 times a box's sizes: their
        # distances tie in exact arithmetic, and which of them tie in f32
        # follows the rounding of the sum of squares, which the JAX CPU path
        # computes as fma(dz, dz, fma(dy, dy, dx * dx))
        unit = (np.stack(np.meshgrid(*[np.arange(8)] * 3, indexing="ij"), -1).reshape(-1, 3)
                + 0.5) / 8 - 0.5
        xyz = (unit[None] * rng.uniform(2, 6, (2, 1, 3))).astype(np.float32)
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
    for b, n in ((1, 16384), (2, 4096), (4, 1024), (8, 16384), (16, 16384)):
        assert sampling.fps_route(b, n) == "cluster"
    # many clouds keep one block each: the RCNN's 400 at batch 4, 100 at batch 1
    for b, n in ((17, 16384), (100, 512), (400, 128)):
        assert sampling.fps_route(b, n) == "block"
    monkeypatch.setattr(sampling, "fps_route", lambda b, n: "warp")
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


@pytest.mark.parametrize("kind,b,n,c,m", [
    ("gaussian", 2, 200, 9, 50), ("gaussian", 2, 300, 9, 60), ("lattice", 2, 200, 4, 80),
    ("duplicates", 1, 257, 67, 100), ("lattice", 3, 64, 1, 64), ("gaussian", 1, 50, 131, 50),
])
def test_ffps_plain_matches_distance_matrix_recurrence(kind, b, n, c, m):
    """The plain F-FPS computes the last pick's row of squared distances at
    each step; its picks equal those of the recurrence over the whole
    [b, n, n] matrix, ties included (small-integer lattices; every row
    twice)."""
    rng = np.random.RandomState(n + c)
    if kind == "gaussian":
        fused = rng.randn(b, n, c).astype(np.float32)
    elif kind == "lattice":
        fused = rng.randint(-2, 3, size=(b, n, c)).astype(np.float32)
    else:
        half = rng.randn(b, (n + 1) // 2, c).astype(np.float32)
        fused = np.concatenate([half, half[:, ::-1]], axis=1)[:, :n].copy()
    d = sampling.fused_square_distance(_t(fused))
    np.testing.assert_array_equal(
        sampling.ffps_plain(_t(fused), m).numpy(),
        sampling.fps_from_dist_plain(d, m).numpy())


def test_fps_pick_shortfall_flags_a_wrong_pick():
    fused = _t(_cloud(6, 1, 100))
    picks = sampling.fps_plain(fused, 20)
    assert sampling.fps_pick_shortfall(fused, picks) == 0.0
    bad = picks.clone()
    bad[0, 5] = bad[0, 4]  # a point already picked has distance 0
    assert sampling.fps_pick_shortfall(fused, bad) == 1.0


def test_ffps_cluster_plan_and_the_slice_fits_rule():
    """K2's cluster route at the path's shapes: SA2 (4,096 x 67) fits over 8
    or 16 CTAs (over 8: 512 + 16 rows of 68 floats and 512 distances,
    145,664 bytes), not over 4;
    SA3 (512 x 131) fits at every size; rows are an odd number of 16-byte
    vectors; a CTA asks for at least 120 KB so that one takes an SM."""
    assert [sampling.ffps_row_stride(c) for c in (3, 10, 67, 131, 256)] == [4, 12, 68, 132, 260]
    for c in (1, 7, 10, 64, 67, 131, 259):
        vec = sampling.ffps_row_stride(c) // 4
        assert vec % 2 == 1 and 4 * vec >= c
    sa2 = sampling.ffps_cluster_plan(4096, 67, 8)
    assert sa2 == dict(slice=512, threads=512, stride=68, smem=145_664)
    assert [sampling.ffps_cluster_fits(4096, 67, s) for s in (16, 8, 4, 2)] == [True, True, False,
                                                                              False]
    assert all(sampling.ffps_cluster_fits(512, 131, s) for s in (16, 8, 4, 2))
    small = sampling.ffps_cluster_plan(512, 131, 16)
    assert small["threads"] == 32 and small["smem"] == sampling.FFPS_SPREAD_SMEM
    assert sampling.ffps_cluster_plan(777, 10, 16)["slice"] * 16 >= 777  # a partial last slice
    assert not sampling.ffps_cluster_fits(8192, 259, 16)  # too wide for any size


def test_ffps_route_follows_the_shape(monkeypatch):
    """The largest fitting size at which all b clusters are resident (the
    occupancy here is a stand-in for the card's: 16 clusters of 2 or 4, 8 of
    8, 4 of 16); the one-block route where none is."""
    resident = {16: 4, 8: 8, 4: 16, 2: 16}
    monkeypatch.setattr(_build, "ffps_max_clusters", lambda n, c, size: resident[size])
    assert [sampling.ffps_cluster_size(b, 4096, 67) for b in (1, 2, 4, 8, 16)] == [16, 16, 16, 8, 0]
    assert [sampling.ffps_route(b, 4096, 67) for b in (8, 16)] == ["cluster", "block"]
    assert [sampling.ffps_cluster_size(b, 512, 131) for b in (1, 8, 16, 17)] == [16, 8, 4, 0]
    # a forced cluster route where no size fits raises; so does an unknown route
    monkeypatch.setattr(sampling, "ffps_route", lambda b, n, c: "cluster")
    with pytest.raises(ValueError, match="no cluster size fits"):
        sampling._ffps_cuda(torch.zeros(16, 4096, 67), 8)
    monkeypatch.setattr(sampling, "ffps_route", lambda b, n, c: "warp")
    with pytest.raises(ValueError, match="unknown route"):
        sampling._ffps_cuda(torch.zeros(1, 8, 3), 4)
    monkeypatch.setattr(sampling, "ffps_route", lambda b, n, c: "block")
    with pytest.raises(ValueError, match="one-block route takes n <= 8192"):
        sampling._ffps_cuda(torch.zeros(1, 8193, 3), 4)


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


def test_ball_query_route_follows_the_shape(monkeypatch):
    # the grid from SA2's 4,096 points up (SA1, the RPN's SA1 and SA2); the
    # brute-force scan for small clouds (SA3, CG-SA, the RCNN's RoIs)
    for n in (4096, 16384):
        assert grouping.ball_query_route(n) == "grid"
    for n in (64, 512, 1024, 16385):
        assert grouping.ball_query_route(n) == "brute"
    xyz = torch.zeros(1, 16385, 3)
    monkeypatch.setattr(grouping, "ball_query_route", lambda n: "grid")
    with pytest.raises(ValueError, match="grid route takes n <= 16384"):
        grouping._ball_query_cuda(grouping.ring_specs([1.0], [4], False), xyz, xyz[:, :2])
    monkeypatch.setattr(grouping, "ball_query_route", lambda n: "octree")
    with pytest.raises(ValueError, match="unknown route"):
        grouping._ball_query_cuda(grouping.ring_specs([1.0], [4], False), xyz, xyz[:, :2])


def test_grid_cell_cap_and_least_edge():
    assert [grouping.grid_cell_cap(n) for n in (1, 16, 512, 4096, 16384)] == [64, 64, 2048,
                                                                             16384, 65536]
    for radii, dilated in (([0.2, 0.4, 0.8], True), ([4.8, 6.4], False), ([0.1, 0.5], False)):
        specs = grouping.ring_specs(radii, [8] * len(radii), dilated)
        cell = grouping.grid_cell_min(specs)
        assert cell >= max(radii) * (1 + grouping.GRID_MARGIN) * (1 - 1e-7)
        assert cell >= np.sqrt(max(s[1] for s in specs)) * (1 + grouping.GRID_MARGIN)


@pytest.mark.parametrize("radius", [0.1, 0.2, 0.8, 1.6, 4.8, 6.4])
def test_grid_cell_holds_every_hit(radius):
    """Every pair whose f32 d2 lies inside the outer ring is within one cell
    along each axis, with the cell computed from the f32 hi2 as the wrapper
    does and each coordinate's cell by the kernel's formula (floor((x - lo) /
    cell) in double precision): pairs on the ring along each axis, pairs
    jittered around it, and boundaries of cells at KITTI ranges."""
    specs = grouping.ring_specs([radius], [8], False)
    hi2 = np.float32(specs[0][1])
    cell = grouping.grid_cell_min(specs)
    rng = np.random.RandomState(31)
    lo = np.float32(-39.7)
    q = rng.uniform(-40, 70, size=(20000, 3)).astype(np.float32)
    q[:2000] = (lo + np.float64(cell) * rng.randint(0, 100, size=(2000, 3))).astype(np.float32)
    off = rng.randn(20000, 3)
    off[:5000] = np.eye(3)[rng.randint(0, 3, 5000)] * rng.choice([-1, 1], size=(5000, 1))
    off /= np.linalg.norm(off, axis=1, keepdims=True)
    p = (q + off * radius * (1 + rng.uniform(-1e-6, 1e-6, size=(20000, 1)))).astype(np.float32)
    d = q - p  # f32, as the kernel rounds it
    d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
    inside = d2 < hi2
    assert inside.sum() > 1000

    def cell_of(x):
        return np.floor((x.astype(np.float64) - np.float64(lo)) / cell)

    gap = np.abs(cell_of(q) - cell_of(p))[inside]
    assert gap.max() <= 1
    assert (np.abs(q.astype(np.float64) - p)[inside] < cell).all()


def _scatter_case(seed, n, c, rows):
    """Two clouds: indices with clamped ends and duplicates, rows of g of
    magnitudes 1e-3 to 1e3, so that the order of a sum shows in its bits."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(-2, n + 2, size=(2, rows)).astype(np.int32)  # clamped ends
    idx[:, 1::4] = idx[:, ::4][:, :idx[:, 1::4].shape[1]]  # duplicates
    g = rng.randn(2, rows, c) * 10.0 ** rng.uniform(-3, 3, size=(2, rows, 1))
    return idx, _t(g.astype(np.float32))


@pytest.mark.parametrize("n,c,rows", [(4096, 67, 65536), (7, 5, 1000)])
def test_scatter_add_plain_adds_rows_in_ascending_order(n, c, rows):
    """The plain version (index_add_ on the CPU) equals, bit for bit, adding
    each destination's rows one at a time in ascending row order from zero:
    the order K5 keeps. The reverse order gives other bits."""
    idx, g = _scatter_case(40, n, c, rows)
    got = grouping.scatter_add_rows_plain(_t(idx), g, n).numpy()
    dest = np.clip(idx, 0, n - 1)
    g = g.numpy()
    for order in ("ascending", "descending"):
        want = np.zeros((2, n, c), np.float32)
        for bt in range(2):
            pos = np.argsort(dest[bt], kind="stable")  # each destination's rows, ascending
            if order == "descending":
                pos = np.argsort(dest[bt][::-1], kind="stable")
                pos = rows - 1 - pos
            seg = dest[bt][pos]
            rank = np.arange(rows) - np.searchsorted(seg, seg)  # a row's place in its destination
            for k in range(rank.max() + 1):  # the k-th row of every destination at once
                at = pos[rank == k]
                want[bt, dest[bt][at]] += g[bt, at]
        if order == "ascending":
            assert np.array_equal(got.view(np.int32), want.view(np.int32))
        else:
            assert not np.array_equal(got, want)


def test_plain_ball_query_matches_jax_on_a_kitti_scene():
    """SA1's rings on a synthetic KITTI scene (ground, clutter, car shells),
    queries on its points: dense car shells fill the rings, so first-k order,
    capping and padding all count. idx and cnt exactly equal."""
    from ssd3d_torch.utils.synth import make_scene

    pts, _ = make_scene(np.random.default_rng(41), n_points=16384)
    xyz = pts[None, :16384, :3].astype(np.float32).copy()
    rng = np.random.RandomState(42)
    q = xyz[:, rng.choice(16384, 256, replace=False)].copy()
    q[:, -64:] = xyz[:, -64:]  # the cloud's last points: car shells or the top-up ground
    radii, ns = [0.2, 0.4, 0.8], [32, 32, 64]
    want = jgrouping.ball_query_multi(radii, ns, jnp.asarray(xyz), jnp.asarray(q), dilated=True)
    got = grouping.ball_query_multi(radii, ns, _t(xyz), _t(q), dilated=True)
    full = 0
    for (gi, gc), (wi, wc), k in zip(got, want, ns):
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        full += int((gc.numpy() == k).sum())
    assert full > 0  # some ring filled


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
    sampling.farthest_point_sample_from_dist(sampling.fused_square_distance(xyz), 8)
    boxes = torch.cat([xyz[0, :, [0, 2]], xyz[0, :, [0, 2]] + 1.0], -1)
    nms.nms_bev(boxes, xyz[0, :, 1], 8, 0.3)
    grouping.ball_query_attention(1.0, 4, xyz, xyz[:, :5], xyz, xyz[:, :5])
    assert _build.launches() == {"fps": 0, "ffps": 0, "ball_query": 0, "gather": 0,
                                 "scatter_add": 0, "three_nn": 0, "sa_fused": 0,
                                 "ffps_dist": 0, "nms_keep": 0, "ball_query_attention": 0}
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
        monkeypatch.setattr(sampling, "fps_route", lambda b, n: route)
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


def _ffps_cloud(kind, b, n, c):
    rng = np.random.RandomState(28)
    if kind == "gaussian":
        return rng.randn(b, n, c).astype(np.float32)
    # every row twice, the copy in the other half of the cloud: equal
    # distances in different CTAs, whose tie the lower index must win
    half = rng.randn(b, (n + 1) // 2, c).astype(np.float32)
    return np.concatenate([half, half[:, ::-1]], axis=1)[:, :n].copy()


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["block", "cluster"])
@pytest.mark.parametrize("b,n,c,m,kind", [
    (1, 4096, 67, 128, "gaussian"), (2, 4096, 67, 128, "duplicates"),
    (8, 4096, 67, 512, "gaussian"),    # SA2
    (16, 4096, 67, 64, "gaussian"),    # SA2's shape at 16 clouds: no cluster size fits
    (8, 512, 131, 256, "duplicates"),  # SA3
    (8, 4095, 67, 64, "duplicates"),   # a partial last slice
    (2, 777, 10, 100, "gaussian"), (16, 512, 131, 64, "gaussian"),
])
def test_ffps_kernel_equals_plain(cuda, b, n, c, m, kind, route, monkeypatch):
    """Picks equal to the plain version's (same arithmetic, channels summed
    in order) on every route, or a clear error where the route does not fit."""
    monkeypatch.setattr(sampling, "ffps_route", lambda b_, n_, c_: route)
    fused = _t(_ffps_cloud(kind, b, n, c)).to(cuda)
    _build.reset_launches()
    if route != "block" and not sampling.ffps_cluster_size(b, n, c):
        with pytest.raises(ValueError, match="no cluster size fits"):
            sampling.farthest_point_sample_features(fused, m)
        return
    got = sampling.farthest_point_sample_features(fused, m)
    assert _build.route_launches()["ffps"] == {route: 1}
    assert torch.equal(got, sampling.ffps_plain(fused, m))


@pytest.mark.cuda
def test_ffps_routes_by_shape_on_the_card(cuda):
    """SA2 and SA3 at 8 clouds take the cluster route, SA2 at 16 the one-block
    route (no cluster size both fits and keeps 16 clusters resident)."""
    assert sampling.ffps_cluster_size(8, 4096, 67) in (8, 16)
    assert sampling.ffps_route(8, 512, 131) == "cluster"
    assert sampling.ffps_route(16, 4096, 67) == "block"


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["grid", "brute"])
@pytest.mark.parametrize("dilated", [True, False])
def test_ball_query_kernel_equals_plain(cuda, dilated, route, monkeypatch):
    monkeypatch.setattr(grouping, "ball_query_route", lambda n: route)
    xyz = _cloud(15, 2, 5000, scale=3.0)
    q = _queries(xyz, 700, 16)
    want = grouping.ball_query_multi([0.2, 0.4, 0.8], [32, 32, 64], _t(xyz), _t(q),
                                     dilated=dilated)
    _build.reset_launches()
    got = grouping.ball_query_multi([0.2, 0.4, 0.8], [32, 32, 64], _t(xyz).to(cuda),
                                    _t(q).to(cuda), dilated=dilated)
    assert _build.route_launches()["ball_query"] == {route: 1}
    for (gi, gc), (wi, wc) in zip(got, want):
        np.testing.assert_array_equal(gc.cpu().numpy(), wc.numpy())
        np.testing.assert_array_equal(gi.cpu().numpy(), wi.numpy())


def _ball_case(case):
    """(xyz [2, n, 3], queries [2, m, 3], radii, ns) for one grid hazard."""
    rng = np.random.RandomState(29)
    radii, ns = [0.2, 0.4, 0.8], [32, 32, 64]
    if case == "edges":
        # a lattice on multiples of the grid's cell from the cloud's corner
        # (the cell is the least one: the cloud spans 20 cells an axis), and
        # points at exactly each ring's radius from a query along each axis
        cell = grouping.grid_cell_min(grouping.ring_specs(radii, ns, True))
        lat = np.stack(np.meshgrid(*[np.arange(20)] * 3, indexing="ij"), -1).reshape(-1, 3)
        on_cells = (lat * cell).astype(np.float32)
        q = on_cells[rng.choice(len(on_cells), 300, replace=False)]
        ring = np.concatenate([q + s * r * np.eye(3)[a] for r in radii + [cell]
                               for a in range(3) for s in (-1, 1)]).astype(np.float32)
        pts = np.concatenate([on_cells, ring])
        xyz = np.stack([pts, pts[::-1]])
        qs = np.stack([q, q[::-1]])
    elif case == "far":  # queries far outside the grid, and just outside it
        xyz = _cloud(30, 2, 3000, scale=3.0)
        qs = _queries(xyz, 400, 31)
        qs[:, ::5] = xyz.max(1, keepdims=True) + 0.5
        qs[:, 1::5] = xyz.min(1, keepdims=True) - 0.3
    elif case == "dense":  # thousands of points in one cell among sparse ones
        xyz = _cloud(32, 2, 3000, scale=5.0)
        xyz[:, :2500] = (rng.rand(2, 2500, 3) * 0.05).astype(np.float32)
        qs = np.concatenate([xyz[:, 2400:2600], xyz[:, -100:]], 1)
    elif case == "outlier":  # one point 100 km away grows every cell
        xyz = _cloud(33, 2, 3000, scale=3.0)
        xyz[:, 1234] = 1e5
        qs = _queries(xyz, 300, 34)
    elif case == "identical":  # every point the same
        xyz = np.full((2, 3000, 3), 1.5, np.float32)
        qs = np.concatenate([xyz[:, :10], xyz[:, :10] + np.float32(0.3),
                             xyz[:, :10] + np.float32(0.1)], 1)
    else:  # "ns > n": 20 points, rings of 32 and 64
        xyz = _cloud(35, 2, 20, scale=0.3)
        qs = _queries(xyz, 40, 36)
    return xyz, qs.astype(np.float32), radii, ns


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["grid", "brute"])
@pytest.mark.parametrize("dilated", [True, False])
@pytest.mark.parametrize("case", ["edges", "far", "dense", "outlier", "identical", "ns > n"])
def test_ball_query_kernel_hazards(cuda, case, dilated, route, monkeypatch):
    monkeypatch.setattr(grouping, "ball_query_route", lambda n: route)
    xyz, q, radii, ns = _ball_case(case)
    want = grouping.ball_query_multi(radii, ns, _t(xyz), _t(q), dilated=dilated)
    got = grouping.ball_query_multi(radii, ns, _t(xyz).to(cuda), _t(q).to(cuda), dilated=dilated)
    for (gi, gc), (wi, wc) in zip(got, want):
        np.testing.assert_array_equal(gc.cpu().numpy(), wc.numpy())
        np.testing.assert_array_equal(gi.cpu().numpy(), wi.numpy())
    assert int(want[-1][1].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["grid", "brute"])
def test_ball_query_kernel_takes_more_clouds_than_a_grid_column(cuda, route, monkeypatch):
    """b > 65,535 (the grid's y limit): both query kernels loop over the
    clouds, and every cloud equals the plain version's."""
    monkeypatch.setattr(grouping, "ball_query_route", lambda n: route)
    rng = np.random.RandomState(37)
    b = 65535 + 2
    xyz = (rng.rand(b, 16, 3) * 0.5).astype(np.float32)
    q = xyz[:, :2] + np.float32(0.05)
    want = grouping.ball_query_multi([0.2, 0.4], [4, 8], _t(xyz), _t(q), dilated=True)
    got = grouping.ball_query_multi([0.2, 0.4], [4, 8], _t(xyz).to(cuda), _t(q).to(cuda),
                                    dilated=True)
    for (gi, gc), (wi, wc) in zip(got, want):
        assert torch.equal(gc.cpu(), wc) and torch.equal(gi.cpu(), wi)
    assert int(want[-1][1][-1].sum()) > 0  # the last cloud has hits


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
    """Bit for bit the CPU plain version (index_add_), and two launches bit
    for bit each other: K5 adds each destination's rows in ascending row
    order, with no float atomics."""
    idx, g = _scatter_case(19, n, c, rows)
    want = grouping.scatter_add_rows_plain(_t(idx), g, n)
    got = grouping.scatter_add_rows(_t(idx).to(cuda), g.to(cuda), n)
    again = grouping.scatter_add_rows(_t(idx).to(cuda), g.to(cuda), n)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, again)
    with pytest.raises(ValueError, match="f32"):
        grouping.scatter_add_rows(_t(idx).to(cuda), g.to(cuda).double(), n)


@pytest.mark.cuda
def test_scatter_add_kernel_takes_more_than_2_31_rows(cuda):
    """b * rows = 2^31 + 2 (two clouds of 2^30 + 1 rows, one channel): every
    offset into g and the kernel's CSR passes 32 bits. About 35 GB on the
    card at its peak. The CPU plain version is not run at this size (its
    index_add_ would take ~50 GB of host memory and minutes); each
    destination d's rows all carry (d % 3) + 1, so its sum is exact in f32
    in any order and comes in closed form."""
    b, rows, n = 2, 2 ** 30 + 1, 2 ** 24
    r = torch.arange(rows, dtype=torch.int32, device=cuda)
    idx = torch.stack([r % n, (r + 1) % n])
    del r
    g = (idx % 3 + 1).float()[..., None]
    got = grouping.scatter_add_rows(idx, g, n)
    del idx, g
    d = torch.arange(n, device=cuda)
    count = torch.stack([64 + (d == 0).int(), 64 + (d == 1).int()])  # rows = 64 n + 1
    want = (count * (d % 3 + 1))[..., None].float()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_kernels_count_their_launches(cuda):
    _build.reset_launches()
    xyz = torch.randn(1, 256, 3, device=cuda)
    sampling.farthest_point_sample(xyz, 8)
    sampling.farthest_point_sample(xyz, 8)
    with pytest.MonkeyPatch.context() as mp:  # both routes are the one kernel's
        mp.setattr(sampling, "fps_route", lambda b, n: "block")
        sampling.farthest_point_sample(xyz, 8)
    assert _build.launches()["fps"] == 3
    assert _build.route_launches()["fps"] == {"cluster": 2, "block": 1}
    assert os.path.exists(_build.library_path())
