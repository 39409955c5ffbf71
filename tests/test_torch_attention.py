"""Attention-ordered grouping in the PyTorch port against the JAX package on
the CPU: `square_distance`, `ball_query_attention` (integer outputs equal,
and the multiset of a sorted visitation through `ball_query_withidx`),
`ball_query_withidx`, `knn_points`, and the shrunk flagship with attention
grouping on SA1 and SA2 (the arrangement of `tests/test_train.py`'s
attention step): the forward, then one train step's losses, gradient leaves
and BatchNorm statistics from a shared state.

Inputs and weights are made with numpy from seeds; the weights reach the
port through `flax_to_state_dict`. The JAX side runs on the CPU, jitted, as
its own tests run it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from ssd3d.core import geometry as jgeometry
from ssd3d.models import build_detector as jax_build_detector
from ssd3d.ops import grouping as jgrouping
from ssd3d.train.train_step import TrainGraph as JaxTrainGraph
from ssd3d_torch.core import geometry
from ssd3d_torch.entry import synthetic_scenes
from ssd3d_torch.models.single_stage import build_detector
from ssd3d_torch.ops import _build, grouping
from ssd3d_torch.train import schedules
from ssd3d_torch.train.train_step import TrainGraph
from ssd3d_torch.utils.convert import flax_to_state_dict

# square_distance: a^2 + b^2 - 2ab in f32, the products summed in another
# order than XLA's; relative to the largest |d|.
SQDIST_RTOL = 1e-6
# the shrunk model at f32: head outputs relative to their largest |value|
# (about 20 layers whose matrix products sum in another order than XLA's)
F32_TOL = 1e-4
# one train step: each loss relative to itself, BatchNorm statistics
# relative to the largest |entry| of each buffer
LOSS_RTOL, STATS_RTOL = 1e-4, 1e-4
# gradient leaves as ||g_port - g_jax|| / ||g_jax||: the step is
# ill-conditioned in f32 (tests/test_torch_train.py FLAGSHIP_GRAD_TOL)
GRAD_TOL = 5e-2


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close_rel(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= rtol * max(np.abs(want).max(), 1e-30), (what, err, np.abs(want).max())


def _cloud(seed, b=2, n=700, m=90, cf=9):
    rng = np.random.RandomState(seed)
    xyz = (rng.randn(b, n, 3) * 1.5).astype(np.float32)
    feats = rng.randn(b, n, cf).astype(np.float32)
    return xyz, xyz[:, :m].copy(), feats, feats[:, :m].copy()


@pytest.mark.parametrize("normalize", [False, True])
def test_square_distance_matches_jax(normalize):
    _, _, f, nf = _cloud(0, cf=33)
    want = np.asarray(jgeometry.square_distance(jnp.asarray(nf), jnp.asarray(f), normalize))
    got = geometry.square_distance(_t(nf), _t(f), normalize)
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 90, 700)
    if normalize:
        # sqrt(d) / c: the square root magnifies the rounding of d near 0
        # (each point's distance to itself), so the squares are held
        assert (got >= 0).all()
        got, want = (got * 33) ** 2, (want.astype(np.float64) * 33) ** 2
    _close_rel(np.asarray(got), want, SQDIST_RTOL, "square_distance")


@pytest.mark.parametrize("radius,ns", [(0.5, 16), (1.0, 32), (2.0, 64), (3.0, 800)])
def test_ball_query_attention_equals_jax(radius, ns):
    """idx and cnt equal JAX's exactly, in one chunk and in chunks of 7
    queries; ns 800 exceeds the cloud (every ball is short)."""
    xyz, q, f, nf = _cloud(1)
    wi, wc = jgrouping.ball_query_attention(radius, ns, *map(jnp.asarray, (xyz, q, f, nf)))
    gi, gc = grouping.ball_query_attention(radius, ns, *map(_t, (xyz, q, f, nf)))
    assert gi.dtype == gc.dtype == torch.int32 and gi.shape == (2, 90, ns)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    assert 0 < float(gc.float().mean()) <= ns and int(gc.min()) >= 1  # each centre is in its ball
    pairs = grouping.ATTN_CHUNK_PAIRS
    try:
        grouping.ATTN_CHUNK_PAIRS = grouping.ATTN_CHUNK_CLOUDS * 700 * 7  # 2 clouds count as 8
        assert grouping.attention_chunk(2, 90, 700) == 7
        ci, cc = grouping.ball_query_attention(radius, ns, *map(_t, (xyz, q, f, nf)))
    finally:
        grouping.ATTN_CHUNK_PAIRS = pairs
    assert torch.equal(ci, gi) and torch.equal(cc, gc)


def test_attention_chunk_bounds_the_pairs_of_a_concrete_batch():
    """SA1 of the flagship, 4,096 queries over 16,384 points: a concrete
    batch past ATTN_CHUNK_CLOUDS keeps b x chunk x n within
    ATTN_CHUNK_PAIRS; a smaller or symbolic batch takes the chunk of
    ATTN_CHUNK_CLOUDS clouds."""
    from torch.fx.experimental.symbolic_shapes import ShapeEnv

    assert [grouping.attention_chunk(b, 4096, 16384) for b in (1, 8, 16, 64, 4096, 65536)] == [
        2048, 2048, 1024, 256, 4, 1]  # at least 1
    for b in (9, 16, 48, 64):
        assert b * grouping.attention_chunk(b, 4096, 16384) * 16384 <= grouping.ATTN_CHUNK_PAIRS
    assert grouping.attention_chunk(ShapeEnv().create_unbacked_symint(), 4096, 16384) == 2048
    assert grouping.attention_chunk(2, 5, 16384) == 5  # at most m


def test_ball_query_attention_is_the_sorted_visitation_multiset():
    """The reference visits each query's points in descending feature
    distance (a stable argsort) and takes the first ns inside the radius:
    `ball_query_withidx` with that order emits the same multiset per ball."""
    xyz, q, f, nf = _cloud(2)
    d = geometry.square_distance(_t(nf), _t(f))
    order = torch.argsort(-d, dim=-1, stable=True).to(torch.int32)
    for radius, ns in [(0.6, 8), (1.2, 32), (2.5, 48)]:
        gi, gc = grouping.ball_query_attention(radius, ns, *map(_t, (xyz, q, f, nf)))
        si, sc = grouping.ball_query_withidx(radius, ns, _t(xyz), _t(q), order)
        assert torch.equal(gc, sc)
        assert torch.equal(gi.sort(-1).values, si.sort(-1).values)


def test_ball_query_withidx_matches_jax():
    xyz, q, f, nf = _cloud(3)
    order = np.argsort(-np.asarray(jgeometry.square_distance(jnp.asarray(nf), jnp.asarray(f))),
                       axis=-1, kind="stable").astype(np.int32)
    order[:, 5] = order[:, 5, ::-1]  # any caller order
    for radius, ns in [(0.3, 4), (1.0, 32), (9.0, 700)]:
        wi, wc = jgrouping.ball_query_withidx(radius, ns, jnp.asarray(xyz), jnp.asarray(q),
                                              jnp.asarray(order))
        gi, gc = grouping.ball_query_withidx(radius, ns, _t(xyz), _t(q), _t(order))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))


@pytest.mark.parametrize("k", [1, 3, 16])
def test_knn_points_matches_jax(k):
    xyz, q, _, _ = _cloud(4, m=300)
    wd, wi = jgrouping.knn_points(k, jnp.asarray(xyz), jnp.asarray(q))
    gd, gi = grouping.knn_points(k, _t(xyz), _t(q))
    assert gi.dtype == torch.int32 and gi.shape == (2, 300, k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))  # random points: no ties
    _close_rel(gd.numpy(), wd, 1e-6, "dist2")
    assert np.all(np.diff(gd.numpy(), axis=-1) >= 0)


# ------------------------------------ the shrunk flagship with attention

def _attention_cfg():
    cfg, _, _, n = __graft_entry__._flagship(shrink=16)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    arch = cfg.MODEL.NETWORK.FIRST_STAGE.ARCHITECTURE
    arch[0][10] = True  # SA1 and SA2 group in feature-distance order
    arch[1][10] = True
    return cfg, n


def _fill(shapes, seed):
    """Seeded flax variables: xavier-like kernels (vote offsets scaled down
    so that the shifted candidates stay near the cars), small biases,
    BatchNorm statistics off their init values."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            lim = np.sqrt(6.0 / (s.shape[0] + s.shape[1]))
            if any(getattr(p, "key", None) == "vote_offsets" for p in path):
                lim *= 0.1
            return rng.uniform(-lim, lim, s.shape)
        if name == "scale":
            return rng.uniform(0.8, 1.2, s.shape)
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape)
        return rng.uniform(-0.1, 0.1, s.shape)

    return jax.tree_util.tree_map_with_path(lambda p, s: leaf(p, s).astype(np.float32), shapes)


def _inside_boxes(data, seed, frac=0.3):
    """Redraw a share of each scan's points inside its GT boxes, so that a
    1,024-point scan has positives."""
    rng = np.random.RandomState(seed)
    n = data["points"].shape[1]
    for b in range(data["points"].shape[0]):
        boxes = data["gt_boxes"][b][data["gt_labels"][b] > 0]
        k = int(n * frac)
        box = boxes[rng.randint(0, len(boxes), k)]
        local = rng.uniform(-0.5, 0.5, (k, 3)) * box[:, [3, 4, 5]]
        local[:, 1] -= box[:, 4] / 2.0
        c, s = np.cos(box[:, 6]), np.sin(box[:, 6])
        xyz = np.stack([c * local[:, 0] + s * local[:, 2], local[:, 1],
                        -s * local[:, 0] + c * local[:, 2]], -1) + box[:, :3]
        data["points"][b, :k, :3] = xyz.astype(np.float32)
    return data


@pytest.fixture(scope="module")
def attention_flagship():
    cfg, n = _attention_cfg()
    jmodel, jspec = jax_build_detector(cfg)
    data = _inside_boxes(synthetic_scenes(2, n, 21), 21)
    shapes = jax.eval_shape(lambda p: jmodel.init(jax.random.PRNGKey(0), p, False),
                            jnp.asarray(data["points"][:1]))
    variables = _fill(shapes, 22)
    model, spec = build_detector(cfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    return cfg, jmodel, jspec, variables, model, spec, data


def test_attention_flagship_forward_matches_jax(attention_flagship):
    cfg, jmodel, _, variables, model, _, data = attention_flagship
    assert model.backbone.layer1.use_attention and model.backbone.layer2.use_attention
    want = jax.jit(lambda v, p: jmodel.apply(v, p, False))(variables, jnp.asarray(data["points"]))
    _build.reset_launches()
    with torch.inference_mode():
        got = model.eval()(_t(data["points"]))
    assert set(_build.launches().values()) == {0}  # CPU tensors: plain versions only
    # the vote layer's base points are gathered by every layer's picks
    np.testing.assert_array_equal(got["vote_base"][0].numpy(), np.asarray(want["vote_base"][0]))
    for key in ("base_xyz", "cls", "offset", "angle_cls", "angle_res"):
        _close_rel(got[key].numpy(), want[key], F32_TOL, key)


def test_attention_flagship_train_step_matches_jax(attention_flagship):
    """One loss and gradient from the shared state: every loss, every
    gradient leaf and the moved BatchNorm statistics."""
    cfg, jmodel, jspec, variables, model, spec, data = attention_flagship
    jgraph = JaxTrainGraph.build(cfg, jmodel, jspec)
    bn_m = float(schedules.bn_momentum(cfg.SOLVER, 0))
    fn = jax.jit(jax.value_and_grad(jgraph.compute_losses, has_aux=True))
    (total, (losses, stats)), grads = fn(variables["params"], variables["batch_stats"],
                                         {k: jnp.asarray(v) for k, v in data.items()},
                                         jax.random.PRNGKey(1), bn_m)
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    graph = TrainGraph.build(cfg, model, spec)
    model.train()
    model.zero_grad(set_to_none=True)
    got_total, got_losses = graph.compute_losses({k: _t(v) for k, v in data.items()}, bn_m)
    got_total.backward()
    assert set(got_losses) == set(losses) == {"cls", "offset", "angle", "corner", "vote"}
    for key, value in got_losses.items():
        assert float(value.detach()) > 0, key  # positives exist: every loss has a gradient
        _close_rel(float(value.detach()), float(losses[key]), LOSS_RTOL, key)
    _close_rel(float(got_total.detach()), float(total), LOSS_RTOL, "total")
    want_g = flax_to_state_dict({"params": _np(grads)})
    named = dict(model.named_parameters())
    assert set(named) == set(want_g)
    for name, p in named.items():
        ref = want_g[name].double()
        if name.endswith("conv.bias") and name[:-9] + "bn.scale" in named:
            # a Dense bias before BatchNorm has an exact gradient of 0: held
            # against the norm of the same layer's kernel gradient
            ref = want_g[name[:-4] + "kernel"].double()
        err = float((p.grad.double() - want_g[name].double()).norm() / ref.norm())
        assert err <= GRAD_TOL, (name, err)
    assert named["backbone.layer1.mlp0.conv0.conv.kernel"].grad.abs().max() > 0
    buffers = dict(model.named_buffers())
    for name, value in flax_to_state_dict({"batch_stats": _np(stats)}).items():
        _close_rel(buffers[name].numpy(), value.numpy(), STATS_RTOL, name)
