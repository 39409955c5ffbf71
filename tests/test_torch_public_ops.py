"""The port's public op surface (`ssd3d_torch.ops`) against the JAX
package's (`ssd3d.ops`) on the CPU: F-FPS over a given distance matrix
(kernel K2m on the card), D-FPS seeded by earlier picks, sampling by
weight, the single-ring and dilated ball queries, the point-membership IoU,
and `geometry.flip_boxes_x`. Inputs are made with numpy from seeds. The
`cuda`-marked tests hold K2m to its plain version and skip without a GPU.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ssd3d.ops as jops
from ssd3d.core import geometry as jgeometry
from ssd3d.ops import grouping as jgrouping
from ssd3d.ops import sampling as jsampling
import ssd3d_torch.ops as ops
from ssd3d_torch.core import geometry
from ssd3d_torch.ops import _build, sampling

# the JAX package's public ops that wait for the nuScenes slice
NUSCENES_OPS = {"ball_query_attention", "ball_query_withidx", "knn_points", "soft_nms_bev",
                "iou_guided_nms", "points_mask_nms"}


def _t(a):
    return torch.from_numpy(np.array(a))


def test_public_names_are_the_jax_packages_but_the_nuscenes_ones():
    assert set(ops.__all__) == set(jops.__all__) - NUSCENES_OPS
    assert all(callable(getattr(ops, name)) for name in ops.__all__)


def _lattice_dist(b: int, side: int) -> np.ndarray:
    """Squared distances of a regular side^3 lattice, scaled per cloud by a
    power of two: every distance is exact, and from any pick many points
    are equally far, so every pick is a tie broken to the lowest index."""
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
    d = ((g[:, None, :] - g[None, :, :]) ** 2).sum(-1).astype(np.float32)
    return np.stack([d * 2.0 ** k for k in range(b)]).astype(np.float32)


def _random_dist(seed: int, b: int, n: int, c: int = 5) -> np.ndarray:
    f = np.random.RandomState(seed).randn(b, n, c).astype(np.float32)
    return ((f[:, :, None, :] - f[:, None, :, :]) ** 2).sum(-1).astype(np.float32)


@pytest.mark.parametrize("kind,b,n,m", [("random", 2, 300, 64), ("random", 1, 999, 100),
                                        ("lattice", 2, 216, 128), ("asymmetric", 2, 200, 50)])
def test_farthest_point_sample_from_dist_matches_jax(kind, b, n, m):
    if kind == "lattice":
        dist = _lattice_dist(b, 6)
    else:
        dist = _random_dist(n, b, n)
        if kind == "asymmetric":  # the row of the pick is read, not its column
            dist = (dist * np.random.RandomState(1).uniform(0.5, 2.0, dist.shape)).astype(
                np.float32)
    want = np.asarray(jsampling.farthest_point_sample_from_dist(jnp.asarray(dist), m))
    got = ops.farthest_point_sample_from_dist(_t(dist), m)
    assert got.dtype == torch.int32 and got.shape == (b, m)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want[0])) == m  # picks are distinct


def test_farthest_point_sample_from_dist_takes_any_float_dtype_on_the_cpu():
    """The plain loop serves every dtype, as JAX's loop does; the lattice's
    exact distances pick alike in f32 and float64."""
    dist = _lattice_dist(2, 5)
    f32 = ops.farthest_point_sample_from_dist(_t(dist), 40)
    f64 = ops.farthest_point_sample_from_dist(_t(dist).double(), 40)
    assert torch.equal(f32, f64)
    with pytest.raises(ValueError, match=r"\[b, n, n\]"):
        ops.farthest_point_sample_from_dist(_t(dist[:, :10]), 4)


def test_ffps_dist_ppt_covers_the_cloud():
    assert [sampling.ffps_dist_ppt(n) for n in (1, 1024, 1025, 4096, 16384, 16385)] == [
        1, 1, 2, 4, 16, 0]


def test_farthest_point_sample_with_preidx_matches_jax():
    rng = np.random.RandomState(3)
    xyz = (rng.randn(2, 500, 3) * 5).astype(np.float32)
    pre = np.stack([rng.choice(500, 7, replace=False) for _ in range(2)]).astype(np.int32)
    want = np.asarray(jsampling.farthest_point_sample_with_preidx(jnp.asarray(xyz),
                                                                  jnp.asarray(pre), 64))
    got = sampling.farthest_point_sample_with_preidx(_t(xyz), _t(pre), 64)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not any(np.isin(w, p).any() for w, p in zip(want, pre))  # seeds are at distance 0


def test_prob_sample_matches_jax_with_its_gumbel_draws():
    rng = np.random.RandomState(4)
    weights = rng.rand(3, 40).astype(np.float32)
    weights[:, :5] = 0.0  # never drawn
    weights[:, 5] = 50.0  # drawn most
    key = jax.random.PRNGKey(7)
    want = np.asarray(jsampling.prob_sample(jnp.asarray(weights), key, 200))
    gumbel = np.asarray(jax.random.gumbel(key, (3, 200, 40)))
    got = sampling.prob_sample(_t(weights), 200, gumbel=_t(gumbel))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.isin(want, np.arange(5)).any() and (want == 5).mean() > 0.3
    drawn = sampling.prob_sample(_t(weights), 200, generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (3, 200) and not np.isin(drawn.numpy(), np.arange(5)).any()


@pytest.mark.parametrize("dilated", [False, True])
def test_single_ring_ball_queries_match_jax(dilated):
    rng = np.random.RandomState(5)
    xyz = (rng.randn(2, 800, 3) * 2).astype(np.float32)
    new_xyz = xyz[:, :100].copy()
    if dilated:
        want = jgrouping.ball_query_dilated(0.4, 1.2, 24, jnp.asarray(xyz), jnp.asarray(new_xyz))
        got = ops.ball_query_dilated(0.4, 1.2, 24, _t(xyz), _t(new_xyz))
    else:
        want = jgrouping.ball_query(0.8, 24, jnp.asarray(xyz), jnp.asarray(new_xyz))
        got = ops.ball_query(0.8, 24, _t(xyz), _t(new_xyz))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert 0 < got[1].float().mean() < 24


def test_query_points_iou_matches_jax():
    rng = np.random.RandomState(6)
    gt = np.concatenate([rng.uniform([-5, 1, 8], [5, 2, 20], (2, 4, 3)),
                         rng.uniform([3, 1.4, 1.5], [4.5, 1.8, 1.9], (2, 4, 3)),
                         rng.uniform(-np.pi, np.pi, (2, 4, 1))], -1).astype(np.float32)
    anchors = gt[:, rng.randint(0, 4, 30)].copy()
    anchors[..., 0:3] += rng.uniform(-1, 1, (2, 30, 3))
    anchors = anchors.astype(np.float32)
    xyz = (gt[:, rng.randint(0, 4, 600), :3] + rng.randn(2, 600, 3) * [1.5, 0.5, 1.5]).astype(
        np.float32)
    from ssd3d.core.iou import boxes_iou_bev_3d

    iou_3d = np.stack([np.asarray(boxes_iou_bev_3d(jnp.asarray(a), jnp.asarray(g))[1])
                       for a, g in zip(anchors, gt)])
    want = np.asarray(jgrouping.query_points_iou(*[jnp.asarray(x) for x in
                                                   (xyz, anchors, gt, iou_3d)]))
    got = ops.query_points_iou(*[_t(x) for x in (xyz, anchors, gt, iou_3d)])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert (want > 0.1).any() and (want == 0).any()


def test_flip_boxes_x_matches_jax():
    rng = np.random.RandomState(7)
    boxes = rng.uniform(-10, 10, (3, 20, 7)).astype(np.float32)
    np.testing.assert_array_equal(geometry.flip_boxes_x(_t(boxes)).numpy(),
                                  np.asarray(jgeometry.flip_boxes_x(jnp.asarray(boxes))))


# ---------------------------------------------------------------- the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind,b,n,m", [("random", 8, 1024, 256), ("random", 3, 1000, 100),
                                        ("lattice", 2, 216, 128), ("asymmetric", 2, 999, 64),
                                        ("random", 1, 20000, 64)])
def test_ffps_dist_kernel_equals_plain(cuda, kind, b, n, m):
    """K2m's picks equal the plain loop's, on both tiers (registers up to
    16,384 points, the scratch buffer past them), and it counts its
    launches."""
    if kind == "lattice":
        dist = _t(_lattice_dist(b, 6))
    elif n > 4096:  # a [1, 20000, 20000] matrix is 1.6 GB: made on the card
        f = torch.randn(b, n, 4, device=cuda, generator=torch.Generator(cuda).manual_seed(n))
        dist = torch.cdist(f, f).square_()
    else:
        dist = _t(_random_dist(n, b, n))
        if kind == "asymmetric":
            dist = dist * torch.rand(dist.shape, generator=torch.Generator().manual_seed(1))
    dist = dist.to(cuda)
    before = _build.FFPS_DIST.launches
    got = ops.farthest_point_sample_from_dist(dist, m)
    torch.cuda.synchronize()
    assert _build.FFPS_DIST.launches == before + 1
    want = sampling.fps_from_dist_plain(dist, m)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_ffps_dist_kernel_takes_float32_only(cuda):
    with pytest.raises(ValueError, match="float32"):
        ops.farthest_point_sample_from_dist(torch.zeros(1, 8, 8, dtype=torch.float64,
                                                        device=cuda), 4)
