"""Every cloud size the reference takes: the plans of K1's slice route, K2's
stream route and K6's split of the knowns, K3 past four rings, and the
row-wise plain F-FPS.

The plans are held on the CPU as the kernels size them (`csrc/fps.cu`
`slice_plan`, `csrc/ffps.cu` `stream_ppt`, `ops/interpolate.three_nn_slices`);
the occupancy the route choice asks the card for is a stand-in here. Tests
marked `cuda` hold each new route to its plain version on the card and skip
without one.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd3d.ops import grouping as jgrouping
from ssd3d.ops import sampling as jsampling
from ssd3d_torch.ops import _build, grouping, sampling
from ssd3d_torch.ops.interpolate import three_nn_slices

# Relative shortfall allowed for an F-FPS pick below the step's maximum
# (float32 sums rounded in another order differ by ~1e-7 relative).
FFPS_TIE_RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ K1, any n

@pytest.mark.parametrize("n,size,tier,threads,ppt", [
    (16385, 16, "registers", 160, 8),     # just past the whole-cloud routes
    (65536, 16, "registers", 512, 8),     # nuScenes' 65,536 points
    (131072, 16, "registers", 512, 16),   # the register tier's last cloud
    (131073, 16, "shared", 1024, 16),
    (262144, 16, "shared", 1024, 16),     # the shared tier's last cloud
    (262145, 16, "global", 1024, 0),
    (524288, 16, "global", 1024, 0),
    (32768, 4, "registers", 512, 16),
    (32768, 2, "shared", 1024, 16),
    (32768, 1, "global", 1024, 0),        # one block a cloud, points from global memory
    (100, 1, "registers", 32, 4),
])
def test_dfps_slice_plan_tiers(n, size, tier, threads, ppt):
    plan = sampling.dfps_slice_plan(n, size)
    assert (plan["tier"], plan["threads"], plan["ppt"]) == (tier, threads, ppt)
    assert plan["slice"] * size >= n > (plan["slice"] - 1) * size
    if tier != "global":
        assert plan["threads"] * plan["ppt"] >= plan["slice"]  # every point has a thread
    # one CTA an SM, and the shared tier's three planes fit beside 8 KB of keys
    assert sampling.DFPS_SPREAD_SMEM <= plan["smem"] <= 232_448 - 8 * (2 * 512 + 2)
    if tier == "shared":
        assert plan["smem"] >= 12 * plan["slice"]


def test_fps_route_takes_every_n(monkeypatch):
    """Past 16,384 points the slice route, whatever the batch; the
    whole-cloud routes forced onto such a cloud raise rather than launch."""
    for b in (1, 2, 16, 32, 400):
        assert sampling.fps_route(b, 16385) == "slice"
        assert sampling.fps_route(b, 524288) == "slice"
    assert sampling.fps_route(16, 16384) == "cluster"
    assert sampling.fps_route(17, 16384) == "block"
    for route in ("cluster", "block"):
        monkeypatch.setattr(sampling, "fps_route", lambda b, n, route=route: route)
        with pytest.raises(ValueError, match="takes n <= 16384"):
            sampling._fps_cuda(torch.zeros(1, 16385, 3), 4)


def test_dfps_slice_size_prefers_the_register_tier_then_fewer_waves(monkeypatch):
    """The size on the fastest tier, then with the fewest waves, then the
    largest (a stand-in for the card's occupancy, as it read on the H100:
    7 clusters of 16, 15 of 8, 30 of 4, 66 of 2, 132 of 1)."""
    resident = {16: 7, 8: 15, 4: 30, 2: 66, 1: 132}
    monkeypatch.setattr(_build, "dfps_slice_clusters", lambda n, size: resident[size])
    # 32,768 points: the register tier at 16, 8 and 4 (slices of 2,048 to 8,192)
    assert [sampling.dfps_slice_size(b, 32768) for b in (1, 7, 8, 15, 16, 30, 32, 100)] \
        == [16, 16, 8, 8, 4, 4, 4, 4]
    # 65,536 points: the register tier at 16 and 8 only
    assert [sampling.dfps_slice_size(b, 65536) for b in (1, 2, 8, 32)] == [16, 16, 8, 8]
    # 262,144: the shared tier at 16 only; 524,288: the global tier at every size
    assert sampling.dfps_slice_size(1, 262144) == 16
    assert sampling.dfps_slice_size(1, 524288) == 16
    assert sampling.dfps_slice_size(200, 524288) == 1  # two waves of one block a cloud


@pytest.mark.parametrize("kind", ["gaussian", "duplicates"])
def test_dfps_past_16384_points_matches_jax(kind):
    """The reference takes any n: the port's plain version (what a CPU
    tensor takes) gives its picks on a cloud past 16,384 points."""
    rng = np.random.RandomState(31)
    if kind == "gaussian":
        xyz = (rng.randn(1, 16500, 3) * 20).astype(np.float32)
    else:
        half = (rng.randn(1, 8250, 3) * 20).astype(np.float32)
        xyz = np.concatenate([half, half[:, ::-1]], axis=1)
    want = np.asarray(jsampling.farthest_point_sample(jnp.asarray(xyz), 24))
    np.testing.assert_array_equal(sampling.farthest_point_sample(_t(xyz), 24).numpy(), want)


# --------------------------------------------------------- K2, any n and c

def test_ffps_route_order(monkeypatch):
    """The cluster route where a slice fits and all clusters are resident,
    else one block where it takes the shape, else the stream route; SA1's
    features over a full scan ([1, 16384, 67]) no longer raise."""
    resident = {16: 4, 8: 8, 4: 16, 2: 16}
    monkeypatch.setattr(_build, "ffps_max_clusters", lambda n, c, size: resident[size])
    assert sampling.ffps_route(8, 4096, 67) == "cluster"
    assert sampling.ffps_route(16, 4096, 67) == "block"
    assert not any(sampling.ffps_cluster_fits(16384, 67, s) for s in (16, 8, 4, 2))
    assert sampling.ffps_route(1, 16384, 67) == "stream"
    assert sampling.ffps_route(2, 16384, 131) == "stream"
    assert sampling.ffps_route(1, 65536, 4) == "cluster"  # 4,096 x 4 a CTA fits
    assert sampling.ffps_route(16, 65536, 4) == "stream"
    assert sampling.ffps_route(32, 4096, 5000) == "stream"  # too wide for one block
    assert sampling.ffps_block_fits(8192, 4096) and not sampling.ffps_block_fits(8193, 3)


@pytest.mark.parametrize("n,slice_,ppt", [(16384, 1024, 1), (16385, 1025, 2), (65536, 4096, 4),
                                          (131072, 8192, 8), (131073, 8193, 0),
                                          (1_000_000, 62500, 0)])
def test_ffps_stream_plan(n, slice_, ppt):
    """Up to 8 points a thread of 1,024 keep their distances in registers;
    past a slice of 8,192 they go to the scratch buffer."""
    assert sampling.ffps_stream_plan(n) == dict(slice=slice_, ppt=ppt)


def _fused(kind, b, n, c, seed):
    rng = np.random.RandomState(seed)
    if kind == "gaussian":
        return rng.randn(b, n, c).astype(np.float32)
    if kind == "lattice":  # small integers: exactly equal distances everywhere
        return rng.randint(-2, 3, size=(b, n, c)).astype(np.float32)
    half = rng.randn(b, (n + 1) // 2, c).astype(np.float32)  # every row twice
    return np.concatenate([half, half[:, ::-1]], axis=1)[:, :n].copy()


# ------------------------------------------------------------ K3, any rings

def test_ring_groups_split_in_order_and_keep_each_ring():
    specs = grouping.ring_specs([0.1 * (i + 1) for i in range(7)], [4, 8, 4, 16, 4, 8, 2], True)
    groups = grouping.ring_groups(specs)
    assert [len(g) for g in groups] == [4, 3]
    assert [s for g in groups for s in g] == specs  # each (lo2, hi2, ns, annulus) as given
    assert grouping.ring_groups(specs[:4]) == [specs[:4]]
    assert [len(g) for g in grouping.ring_groups(specs + specs)] == [4, 4, 4, 2]


@pytest.mark.parametrize("k", [5, 7])
def test_ball_query_past_four_rings_matches_jax(k):
    """Each ring's idx and cnt depend on that ring only: the plain query of
    k rings equals the reference's, and each group of `ring_groups` queried
    alone gives its rings' part of it."""
    rng = np.random.RandomState(k)
    xyz = (rng.randn(2, 400, 3) * 1.5).astype(np.float32)
    q = xyz[:, :90].copy()
    q[:, 1::2] += rng.randn(2, 45, 3).astype(np.float32) * 0.2
    radii, ns = [0.25 * (i + 1) for i in range(k)], [8, 4, 16, 8, 4, 12, 6][:k]
    got = grouping.ball_query_multi(radii, ns, _t(xyz), _t(q), dilated=True)
    want = jgrouping.ball_query_multi(radii, ns, jnp.asarray(xyz), jnp.asarray(q), dilated=True)
    assert len(got) == k
    for (gi, gc), (wi, wc) in zip(got, want):
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    specs = grouping.ring_specs(radii, ns, True)
    parts = [r for g in grouping.ring_groups(specs)
             for r in grouping.ball_query_multi_plain(g, _t(xyz), _t(q))]
    for (pi, pc), (gi, gc) in zip(parts, got):
        assert torch.equal(pi, gi) and torch.equal(pc, gc)


# ------------------------------------------------------------ K6's plan

@pytest.mark.parametrize("b,n,m,slices", [
    (4, 16384, 4096, 1),   # FP1 at batch 4: 65,536 threads fill the card
    (4, 4096, 1024, 4),    # FP2
    (4, 1024, 256, 8),     # FP3
    (4, 256, 64, 8),       # FP4: 8 knowns a slice
    (1, 16384, 4096, 4),   # FP1 at batch 1
    (2, 1000, 3, 1),       # too few knowns to split
])
def test_three_nn_slices_at_the_fp_shapes(b, n, m, slices):
    s = three_nn_slices(b, n, m)
    assert s == slices
    assert m // s >= 8 or s == 1


# -------------------------------------------------- the new routes on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _fps_cloud(kind, b, n, seed):
    rng = np.random.RandomState(seed)
    if kind == "gaussian":
        return (rng.randn(b, n, 3) * 20).astype(np.float32)
    if kind == "grid_ties":
        return rng.randint(-6, 7, size=(b, n, 3)).astype(np.float32)
    half = (rng.randn(b, (n + 1) // 2, 3) * 20).astype(np.float32)
    return np.concatenate([half, half[:, ::-1]], axis=1)[:, :n].copy()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gaussian", "grid_ties", "duplicates"])
@pytest.mark.parametrize("b,n,size", [
    (1, 65536, None), (2, 40000, None),       # the register tier at the chosen size
    (1, 20000, 2), (3, 30001, 2),             # the shared tier (a partial last slice)
    (1, 20000, 1), (2, 300000, None),         # the global tier
    (40, 20000, None),                        # more clouds than clusters of 16
])
def test_fps_slice_route_equals_plain(cuda, b, n, size, kind, monkeypatch):
    if size is not None:
        monkeypatch.setattr(sampling, "dfps_slice_size", lambda b_, n_: size)
    xyz = _t(_fps_cloud(kind, b, n, n + b)).to(cuda)
    _build.reset_launches()
    got = sampling.farthest_point_sample(xyz, 200)
    assert _build.route_launches()["fps"] == {"slice": 1}
    assert torch.equal(got, sampling.fps_plain(xyz, 200))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 1000])
def test_fps_slice_route_on_small_clouds(cuda, n, monkeypatch):
    """Forced onto clouds the whole-cloud routes take, at every size."""
    monkeypatch.setattr(sampling, "fps_route", lambda b, n: "slice")
    xyz = _t(_fps_cloud("grid_ties", 2, n, 3)).to(cuda)
    want = sampling.fps_plain(xyz, 300)
    for size in sampling.DFPS_SLICE_SIZES:
        monkeypatch.setattr(sampling, "dfps_slice_size", lambda b_, n_, size=size: size)
        assert torch.equal(sampling.farthest_point_sample(xyz, 300), want), size


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gaussian", "duplicates"])
@pytest.mark.parametrize("b,n,c,m", [
    (1, 16384, 67, 128),      # SA1's features over a full scan
    (2, 9000, 131, 64),
    (1, 140000, 16, 32),      # past 8 points a thread: the scratch buffer
])
def test_ffps_stream_route_equals_plain(cuda, b, n, c, m, kind):
    fused = _t(_fused(kind, b, n, c, 50 + c)).to(cuda)
    assert sampling.ffps_route(b, n, c) == "stream"
    _build.reset_launches()
    got = sampling.farthest_point_sample_features(fused, m)
    assert _build.route_launches()["ffps"] == {"stream": 1}
    assert torch.equal(got, sampling.ffps_plain(fused, m))
    assert sampling.fps_pick_shortfall(fused, got) <= FFPS_TIE_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,m", [(2, 4096, 67, 128), (3, 777, 10, 100), (1, 512, 131, 200)])
def test_ffps_stream_route_forced_on_small_clouds(cuda, b, n, c, m, monkeypatch):
    monkeypatch.setattr(sampling, "ffps_route", lambda b_, n_, c_: "stream")
    fused = _t(_fused("lattice", b, n, c, 60)).to(cuda)
    assert torch.equal(sampling.farthest_point_sample_features(fused, m),
                       sampling.ffps_plain(fused, m))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [5, 7])
@pytest.mark.parametrize("route", ["grid", "brute"])
def test_ball_query_kernel_past_four_rings(cuda, k, route, monkeypatch):
    monkeypatch.setattr(grouping, "ball_query_route", lambda n: route)
    rng = np.random.RandomState(k)
    xyz = (rng.randn(2, 4096, 3) * 3).astype(np.float32)
    q = xyz[:, :300].copy()
    q[:, 1::2] += rng.randn(2, 150, 3).astype(np.float32) * 0.3
    radii, ns = [0.2 * (i + 1) for i in range(k)], [8, 4, 16, 8, 4, 12, 6][:k]
    specs = grouping.ring_specs(radii, ns, True)
    want = grouping.ball_query_multi_plain(specs, _t(xyz).to(cuda), _t(q).to(cuda))
    _build.reset_launches()
    got = grouping.ball_query_multi(radii, ns, _t(xyz).to(cuda), _t(q).to(cuda), dilated=True)
    assert _build.route_launches()["ball_query"] == {route: 2}
    for (gi, gc), (wi, wc) in zip(got, want):
        assert torch.equal(gc, wc) and torch.equal(gi, wi)
