"""Parity of the PyTorch port's training slice with the JAX package: train-
mode BatchNorm, target assignment, losses, the gather's gradient, one full
loss + gradient of the shrunk flagship, and the optimizer update.

Inputs are made with numpy from seeds and handed to both packages; weights
come from a seeded flax variable tree through `flax_to_state_dict`. The JAX
side runs on the CPU; its Pallas scatter-add runs in interpret mode.
"""

from __future__ import annotations

import functools
import importlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental import pallas

import __graft_entry__
from ssd3d.core import box_coders as jcoders
from ssd3d.core import geometry as jgeometry
from ssd3d.models import build_detector as jax_build_detector
from ssd3d.nn import layers as jlayers
from ssd3d.ops import grouping as jgrouping
from ssd3d.train import assigner as jassigner
from ssd3d.train import losses as jlosses
from ssd3d.train import schedules as jschedules
from ssd3d.train.train_step import TrainGraph as JaxTrainGraph
from ssd3d.train.train_step import make_optimizer as jax_make_optimizer
from ssd3d_torch.core import box_coders, geometry
from ssd3d_torch.entry import flagship, synthetic_scenes, train_entry
from ssd3d_torch.nn.layers import BatchNorm
from ssd3d_torch.ops import _build, grouping
from ssd3d_torch.train import assigner, losses, schedules
from ssd3d_torch.train.adabound import AdaBound
from ssd3d_torch.train.train_step import TrainGraph, clip_by_global_norm, make_optimizer
from ssd3d_torch.utils.convert import flax_to_state_dict

# f32 losses: sums over a few hundred points taken in another order, ~1e-6
# relative; the stated bound is 1e-4.
LOSS_RTOL = 1e-4
# running statistics: batch means and variances of f32 activations; in the
# flagship, relative to the largest |entry| of each buffer
STATS_RTOL, STATS_ATOL = 1e-4, 1e-5
# gradients of one SA layer: each leaf within this fraction of its largest
# |entry|; the backward sums ~1e4 products in another order than XLA's.
GRAD_TOL = 1e-3
# gradients of the whole shrunk flagship, per leaf, as ||g_port - g_jax|| /
# ||g_jax||. The step is ill-conditioned in f32: a 1e-6 relative change of
# the input intensity moves a leaf's gradient by 2e-3 (measured on this
# batch), through max-pool and ReLU decisions taken anew and BatchNorm over
# few samples; and XLA's f32 batch statistics on the CPU sit 1e-5 (relative)
# from a float64 run where the port's sit 5e-7. Measured worst leaf: 1.5e-2.
FLAGSHIP_GRAD_TOL = 5e-2


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close_rel(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= rtol * max(np.abs(want).max(), 1e-30), (what, err, np.abs(want).max())


# --------------------------------------------------------------- BatchNorm

@pytest.mark.parametrize("momentum", [0.5, 0.99])
def test_batchnorm_train_mode_matches_flax(momentum):
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 40, 8, 24) * 3 + 1).astype(np.float32)
    w = rng.randn(*x.shape).astype(np.float32)  # weights the output for a gradient
    variables = {"params": {"scale": rng.uniform(0.5, 1.5, 24).astype(np.float32),
                            "bias": rng.uniform(-0.2, 0.2, 24).astype(np.float32)},
                 "batch_stats": {"mean": rng.uniform(-0.5, 0.5, 24).astype(np.float32),
                                 "var": rng.uniform(0.5, 2.0, 24).astype(np.float32)}}
    jbn = jlayers.BatchNorm()

    def f(xx):
        out, mut = jbn.apply(variables, xx, True, momentum, mutable=["batch_stats"])
        return jnp.sum(out * w), (out, mut["batch_stats"])

    (_, (want, stats)), want_dx = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
    bn = BatchNorm(24)
    bn.load_state_dict(flax_to_state_dict(variables))
    bn.train()
    xt = _t(x).requires_grad_(True)
    got = bn(xt, momentum)
    (got * _t(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), rtol=1e-4, atol=1e-5)
    for key in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, key).numpy(), np.asarray(stats[key]),
                                   rtol=STATS_RTOL, atol=STATS_ATOL, err_msg=key)


# -------------------------------------------------- geometry and box coder

def _boxes_and_points(seed, n=400):
    rng = np.random.RandomState(seed)
    boxes = np.stack([rng.uniform(-10, 10, 5), rng.uniform(0.5, 2, 5), rng.uniform(5, 30, 5),
                      rng.uniform(2, 5, 5), rng.uniform(1, 2, 5), rng.uniform(1, 2, 5),
                      rng.uniform(-np.pi, np.pi, 5)], -1).astype(np.float32)
    pts = (boxes[rng.randint(0, 5, n), :3]
           + rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)).astype(np.float32)
    return boxes, pts


def test_geometry_matches_jax():
    boxes, pts = _boxes_and_points(1)
    np.testing.assert_allclose(geometry.boxes_to_corners(_t(boxes)).numpy(),
                               np.asarray(jgeometry.boxes_to_corners(jnp.asarray(boxes))),
                               rtol=1e-5, atol=1e-5)
    for expand in (0.0, 0.1):
        got = geometry.points_in_boxes(_t(pts), _t(boxes), expand=expand).numpy()
        want = np.asarray(jgeometry.points_in_boxes(jnp.asarray(pts), jnp.asarray(boxes),
                                                    expand=expand))
        np.testing.assert_array_equal(got, want)
        assert got.any() and not got.all()
    per_pt = boxes[np.arange(len(pts)) % 5]
    np.testing.assert_allclose(geometry.centerness(_t(pts), _t(per_pt)).numpy(),
                               np.asarray(jgeometry.centerness(jnp.asarray(pts),
                                                               jnp.asarray(per_pt))),
                               rtol=1e-4, atol=1e-6)


def test_box_encoder_matches_jax():
    boxes, pts = _boxes_and_points(2, 60)
    gt = np.broadcast_to(boxes[np.arange(60) % 5][None, :, None], (2, 60, 1, 7)).copy()
    gt[1, :, 0, 6] += 7.0  # angles past 2 pi wrap
    ctr = np.broadcast_to(pts[None], (2, 60, 3)).copy()
    want = jcoders.BoxCoder("Dist-Anchor-free", 12).encode(
        jnp.asarray(ctr), jnp.asarray(gt), jnp.asarray(gt))
    got = box_coders.BoxCoder("Dist-Anchor-free", 12).encode(_t(ctr), _t(gt), None)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- assignment

def _scene_batch(seed, n, inside_frac=0.5):
    """Synthetic scenes where a share of the points is redrawn uniformly
    inside the GT boxes, so that a few-point cloud has positives."""
    data = synthetic_scenes(2, n, seed)
    rng = np.random.RandomState(seed)
    for b in range(2):
        boxes = data["gt_boxes"][b][data["gt_labels"][b] > 0]
        k = int(n * inside_frac)
        box = boxes[rng.randint(0, len(boxes), k)]
        local = rng.uniform(-0.5, 0.5, (k, 3)) * box[:, [3, 4, 5]]
        local[:, 1] -= box[:, 4] / 2.0  # bottom face at local y = 0, top at -h
        c, s = np.cos(box[:, 6]), np.sin(box[:, 6])
        xyz = np.stack([c * local[:, 0] + s * local[:, 2], local[:, 1],
                        -s * local[:, 0] + c * local[:, 2]], -1) + box[:, :3]
        data["points"][b, :k, :3] = xyz.astype(np.float32)
    return data


def test_assign_and_vote_targets_match_jax():
    data = _scene_batch(3, 256)
    pts = data["points"][..., :3]
    anchors = pts[:, :, None, :]
    cfg = assigner.AssignerConfig("Mask", -1, 10.0, "BEV", 0.25, 0.6, 0.45)
    jcfg = jassigner.AssignerConfig("Mask", "BEV", -1, 0.25, 0.6, 0.45, 10.0)
    want = jassigner.assign_targets(jcfg, jax.random.PRNGKey(0), jnp.asarray(pts),
                                    jnp.asarray(anchors), jnp.asarray(data["gt_boxes"]),
                                    jnp.asarray(data["gt_labels"]))
    got = assigner.assign_targets(cfg, _t(pts), _t(anchors), _t(data["gt_boxes"]),
                                  _t(data["gt_labels"]))
    assert set(got) == set(want)
    for key in got:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    assert 0 < got["pmask"].sum() < pts.shape[0] * pts.shape[1]
    vm, vt = jassigner.vote_targets(jnp.asarray(pts), jnp.asarray(data["gt_boxes"]), 0.1)
    gm, gt = assigner.vote_targets(_t(pts), _t(data["gt_boxes"]), 0.1)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(vm))
    np.testing.assert_allclose(gt.numpy(), np.asarray(vt), rtol=1e-6, atol=1e-6)
    # IoU assignment of the points' mean-size Car anchors (BEV and 3D IoU),
    # with a minibatch drawn from the JAX assigner's own random numbers
    boxes = np.asarray(jcoders.AnchorGenerator("KITTI", ("Car",), "Bin-Anchor")(jnp.asarray(pts)))
    key = jax.random.PRNGKey(3)
    draws = np.stack([np.stack([np.asarray(jax.random.uniform(k, (pts.shape[1],)))
                                for k in jax.random.split(r)])
                      for r in jax.random.split(key, pts.shape[0])])
    for sample_type in ("BEV", "3D"):
        jcfg = jassigner.AssignerConfig("IoU", sample_type, 24, 0.5, 0.3, 0.2, 10.0)
        want = jassigner.assign_targets(jcfg, key, jnp.asarray(pts), jnp.asarray(boxes),
                                        jnp.asarray(data["gt_boxes"]),
                                        jnp.asarray(data["gt_labels"]))
        got = assigner.assign_targets(
            assigner.AssignerConfig("IoU", 24, 10.0, sample_type, 0.5, 0.3, 0.2), _t(pts),
            _t(boxes), _t(data["gt_boxes"]), _t(data["gt_labels"]), uniforms=_t(draws))
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
        assert 0 < got["pmask"].sum() and 0 < got["nmask"].sum()
        assert (got["pmask"] + got["nmask"]).sum() <= 24 * pts.shape[0]


# ------------------------------------------------------------------ losses

def _loss_inputs(seed, n=128):
    """Random head outputs and the JAX assigner's targets for them."""
    data = _scene_batch(seed, n)
    rng = np.random.RandomState(seed)
    base = data["points"][..., :3]
    outputs = {
        "base_xyz": base,
        "cls": rng.randn(2, n, 1).astype(np.float32),
        "offset": (rng.randn(2, n, 1, 6) * [1, 1, 1, 1.5, 0.7, 0.7]).astype(np.float32),
        "angle_cls": rng.randn(2, n, 1, 12).astype(np.float32),
        "angle_res": (rng.rand(2, n, 1, 12) - 0.5).astype(np.float32),
        "vote_base": [base[:, : n // 2]],
        "vote_offset": [rng.randn(2, n // 2, 3).astype(np.float32)],
    }
    jcfg = jassigner.AssignerConfig("Mask", "BEV", -1, 0.25, 0.6, 0.45, 10.0)
    targets = _np(jassigner.assign_targets(
        jcfg, jax.random.PRNGKey(0), jnp.asarray(base), jnp.asarray(base[:, :, None]),
        jnp.asarray(data["gt_boxes"]), jnp.asarray(data["gt_labels"])))
    return outputs, targets, data


def _jax_tree(x):
    return jax.tree_util.tree_map(jnp.asarray, x)


def _torch_tree(x, grad=False):
    if isinstance(x, dict):
        return {k: _torch_tree(v, grad) for k, v in x.items()}
    if isinstance(x, list):
        return [_torch_tree(v, grad) for v in x]
    return _t(x).requires_grad_(grad and np.issubdtype(np.asarray(x).dtype, np.floating))


def test_elementwise_losses_match_jax():
    rng = np.random.RandomState(4)
    x = (rng.randn(500) * 3).astype(np.float32)
    x[:3] = [1.0, -1.0, 0.0]  # huber's kink and sigmoid_ce's max at a tie
    lab = (rng.rand(500) > 0.5).astype(np.float32)
    logits = rng.randn(50, 4).astype(np.float32)
    idx = rng.randint(0, 4, 50).astype(np.int32)
    pairs = [
        (losses.huber(_t(x)), jlosses.huber(jnp.asarray(x))),
        (losses.sigmoid_ce(_t(x), _t(lab)), jlosses.sigmoid_ce(jnp.asarray(x), jnp.asarray(lab))),
        (losses.focal_loss(_t(x), _t(lab)), jlosses.focal_loss(jnp.asarray(x), jnp.asarray(lab))),
        (losses.softmax_ce(_t(logits), _t(idx)),
         jlosses.softmax_ce(jnp.asarray(logits), jnp.asarray(idx))),
        (losses.softmax_focal_loss(_t(logits), _t(idx)),
         jlosses.softmax_focal_loss(jnp.asarray(logits), jnp.asarray(idx))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    # the gradients at the ties split as JAX's do
    xt = _t(x).requires_grad_(True)
    (losses.huber(xt) + losses.sigmoid_ce(xt, _t(lab))).sum().backward()
    want = jax.grad(lambda v: jnp.sum(jlosses.huber(v) + jlosses.sigmoid_ce(v, jnp.asarray(lab))))(
        jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("activation", ["Sigmoid", "Softmax"])
@pytest.mark.parametrize("loss_type", ["Center-ness", "Is-Not", "Focal-loss"])
def test_classification_loss_matches_jax(activation, loss_type):
    outputs, targets, _ = _loss_inputs(5)
    if activation == "Softmax":
        outputs["cls"] = np.random.RandomState(6).randn(2, 128, 2).astype(np.float32)
    kw = dict(cls_loss_type=loss_type, cls_activation=activation, num_classes=1,
              num_angle_cls=12)
    want, want_g = jax.value_and_grad(
        lambda o: jlosses.classification_loss(jlosses.LossConfig(**kw), o, _jax_tree(targets)))(
        _jax_tree(outputs))
    tout = _torch_tree(outputs, grad=True)
    got = losses.classification_loss(losses.LossConfig(**kw), tout, _torch_tree(targets))
    got.backward()
    _close_rel(got.item(), want, LOSS_RTOL, f"{activation} {loss_type}")
    np.testing.assert_allclose(tout["cls"].grad.numpy(), np.asarray(want_g["cls"]),
                               rtol=1e-4, atol=1e-7)


def test_stage_losses_and_their_gradients_match_jax():
    outputs, targets, data = _loss_inputs(7)
    kw = dict(cls_loss_type="Center-ness", cls_activation="Sigmoid", num_classes=1,
              num_angle_cls=12, corner_loss=True, vote_loss=True)
    jcoder = jcoders.BoxCoder("Dist-Anchor-free", 12)

    def jfn(o):
        d = jlosses.compute_stage_losses(
            jlosses.LossConfig(**kw), jcoder, o, _jax_tree(targets),
            o["base_xyz"][:, :, None, :], o["base_xyz"], jnp.asarray(data["gt_boxes"]))
        return sum(d.values()), d

    (_, want), want_g = jax.value_and_grad(jfn, has_aux=True)(_jax_tree(outputs))
    tout = _torch_tree(outputs, grad=True)
    got = losses.compute_stage_losses(
        losses.LossConfig(**kw), box_coders.BoxCoder("Dist-Anchor-free", 12), tout,
        _torch_tree(targets), tout["base_xyz"][:, :, None, :], tout["base_xyz"],
        _t(data["gt_boxes"]))
    assert set(got) == set(want) == {"cls", "offset", "angle", "corner", "vote"}
    for key in got:
        _close_rel(got[key].item(), want[key], LOSS_RTOL, key)
        assert got[key].item() > 0, key
    sum(got.values()).backward()
    for key in ("base_xyz", "cls", "offset", "angle_cls", "angle_res"):
        _close_rel(tout[key].grad.numpy(), want_g[key], GRAD_TOL, key)
    _close_rel(tout["vote_offset"][0].grad.numpy(), want_g["vote_offset"][0], GRAD_TOL, "vote")


# ------------------------------------------------------ the gather gradient

def test_gather_gradient_matches_jax():
    rng = np.random.RandomState(8)
    pts = rng.randn(2, 50, 67).astype(np.float32)
    idx = rng.randint(0, 50, size=(2, 12, 16)).astype(np.int32)
    idx[:, :, 8:] = idx[:, :, :1]  # padding repeats the first hit: duplicates
    w = rng.randn(2, 12, 16, 67).astype(np.float32)
    want = jax.grad(lambda p: jnp.sum(jgrouping.group_points(p, jnp.asarray(idx)) * w))(
        jnp.asarray(pts))
    pt = _t(pts).requires_grad_(True)
    _build.reset_launches()
    (grouping.group_points(pt, _t(idx)) * _t(w)).sum().backward()
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert set(_build.launches().values()) == {0}  # the plain versions on the CPU


@pytest.fixture
def interpret():
    orig = pallas.pallas_call
    with mock.patch.object(pallas, "pallas_call", functools.partial(orig, interpret=True)):
        yield


def test_scatter_add_plain_matches_pallas_kernel(interpret):
    import ssd3d.ops.pallas.scatter_add as sa

    importlib.reload(sa)
    rng = np.random.RandomState(9)
    b, n, c, rows = 2, 64, 67, 2048
    idx = rng.randint(0, n, size=(b, rows)).astype(np.int32)
    idx[:, ::3] = idx[:, :1]  # many duplicates
    g = rng.randn(b, rows, c).astype(np.float32)
    want = np.asarray(sa.scatter_add_rows_pallas(jnp.asarray(idx), jnp.asarray(g), (b, n, c)))
    got = grouping.scatter_add_rows_plain(_t(idx), _t(g), n)
    assert got.shape == (b, n, c)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(grouping.scatter_add_rows(_t(idx), _t(g), n).numpy(), want,
                               rtol=1e-5, atol=1e-4)


# ------------------------------------------------ the flagship train step

def _fill(shapes, seed):
    """Seeded flax variables: xavier-like kernels (the vote offsets scaled
    down so that the shifted candidates stay near the cars), small biases,
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
        return rng.uniform(-0.1, 0.1, s.shape)  # bias, mean

    return jax.tree_util.tree_map_with_path(lambda p, s: leaf(p, s).astype(np.float32), shapes)


@pytest.fixture(scope="module")
def flagship_step():
    """One jitted JAX loss + gradient of the shrunk flagship (1,024 points,
    batch 2, f32) and the port's on the same weights and batch."""
    cfg, _, _, n = __graft_entry__._flagship(shrink=16)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    jmodel, jspec = jax_build_detector(cfg)
    jgraph = JaxTrainGraph.build(cfg, jmodel, jspec)
    data = _scene_batch(11, n, inside_frac=0.3)
    shapes = jax.eval_shape(lambda p: jmodel.init(jax.random.PRNGKey(0), p, False),
                            jnp.asarray(data["points"][:1]))
    variables = _fill(shapes, 12)
    bn_m = float(jschedules.bn_momentum(cfg.SOLVER, 0))
    fn = jax.jit(jax.value_and_grad(jgraph.compute_losses, has_aux=True))
    (total, (loss_dict, stats)), grads = fn(variables["params"], variables["batch_stats"],
                                            _jax_tree(data), jax.random.PRNGKey(1), bn_m)
    want = dict(total=float(total), losses=_np(loss_dict),
                grads=flax_to_state_dict({"params": _np(grads)}),
                stats=flax_to_state_dict({"batch_stats": _np(stats)}))

    _, model, spec, _ = flagship(shrink=16, compute_dtype="float32", device="cpu")
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    graph = TrainGraph.build(cfg, model, spec)
    model.train()
    _build.reset_launches()
    got_total, got_losses = graph.compute_losses(
        {k: _t(v) for k, v in data.items()}, schedules.bn_momentum(cfg.SOLVER, 0))
    got_total.backward()
    return want, got_total, got_losses, model


def test_flagship_losses_match_jax(flagship_step):
    want, total, loss_dict, _ = flagship_step
    assert set(loss_dict) == set(want["losses"]) == {"cls", "offset", "angle", "corner", "vote"}
    for key, value in loss_dict.items():
        _close_rel(value.item(), want["losses"][key], LOSS_RTOL, key)
    assert all(value.item() > 0 for value in loss_dict.values())  # positives exist
    _close_rel(total.item(), want["total"], LOSS_RTOL, "total")
    assert set(_build.launches().values()) == {0}


def test_flagship_gradients_match_jax(flagship_step):
    want, _, _, model = flagship_step
    grads = {name: p.grad for name, p in model.named_parameters()}
    assert set(grads) == set(want["grads"]) and len(grads) > 150
    for name, g in grads.items():
        assert g is not None, name
        ref = want["grads"][name].double()
        if name.endswith("conv.bias") and name[:-9] + "bn.scale" in grads:
            # a Dense bias before BatchNorm has an exact gradient of 0 (the
            # batch mean takes it out): both sides hold rounding there, held
            # against the norm of the same layer's kernel gradient
            ref = want["grads"][name[:-4] + "kernel"].double()
        err = float((g.double() - want["grads"][name].double()).norm() / ref.norm())
        assert err <= FLAGSHIP_GRAD_TOL, (name, err)
    # the vote layer's offsets reach the losses through the shifted centres
    assert grads["backbone.vote_4.vote_offsets.conv.kernel"].abs().max() > 0


def test_flagship_running_statistics_match_jax(flagship_step):
    want, _, _, model = flagship_step
    buffers = dict(model.named_buffers())
    assert set(want["stats"]) == {k for k in buffers if k.endswith((".mean", ".var"))}
    for name, value in want["stats"].items():
        _close_rel(buffers[name].numpy(), value.numpy(), STATS_RTOL, name)


def test_sa_layer_train_mode_and_gradients_match_jax():
    """One SA layer in train mode (fusion sampling, dilated rings, the
    grouping gather and its scatter-add backward, MLPs with batch
    statistics, max-pool, aggregation): outputs, running statistics and
    every gradient, input features included, to GRAD_TOL per leaf."""
    from ssd3d.nn.modules import PointnetSAModuleMSG as JaxSA
    from ssd3d_torch.nn.modules import PointnetSAModuleMSG

    rng = np.random.RandomState(14)
    xyz = (rng.randn(2, 256, 3) * 2).astype(np.float32)
    feat = rng.randn(2, 256, 13).astype(np.float32)
    args = dict(radius_list=[0.8, 1.6], nsample_list=[16, 32], mlp_list=[[16, 32], [16, 24]],
                bn=True, fps_sample_range_list=[-1], fps_method_list=["FS"], npoint_list=[32],
                dilated_group=True, aggregation_channel=48)
    jmod = JaxSA(use_attention=False, **args)
    shapes = jax.eval_shape(lambda x, f: jmod.init(jax.random.PRNGKey(0), x, f, None, None,
                                                   False), jnp.asarray(xyz), jnp.asarray(feat))
    variables = _fill(shapes, 15)
    w = rng.randn(2, 64, 48).astype(np.float32)

    def f(params, f_in):
        (_, out, idx), mut = jmod.apply({"params": params,
                                         "batch_stats": variables["batch_stats"]},
                                        jnp.asarray(xyz), f_in, None, None, True, 0.9,
                                        mutable=["batch_stats"])
        return jnp.sum(out * w), (out, idx, mut["batch_stats"])

    (_, (want, want_idx, stats)), (gp, gf) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(feat))
    mod = PointnetSAModuleMSG(13, **args)
    mod.load_state_dict(flax_to_state_dict(variables), strict=True)
    mod.train()
    ft = _t(feat).requires_grad_(True)
    _, out, idx = mod(_t(xyz), ft, None, None, 0.9)
    (out * _t(w)).sum().backward()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    _close_rel(out.detach().numpy(), want, 1e-5, "features")
    _close_rel(ft.grad.numpy(), gf, GRAD_TOL, "input features")
    want_g = flax_to_state_dict({"params": _np(gp)})
    for name, p in mod.named_parameters():
        if name.endswith("conv.bias") and name[:-9] + "bn.scale" in want_g:
            continue  # an exact 0 (BatchNorm removes it); rounding on both sides
        _close_rel(p.grad.numpy(), want_g[name], GRAD_TOL, name)
    for name, value in flax_to_state_dict({"batch_stats": _np(stats)}).items():
        _close_rel(dict(mod.named_buffers())[name].numpy(), value, STATS_RTOL, name)


# -------------------------------------------------------------- optimizer

@pytest.mark.parametrize("solver", ["Adam", "SGD"])
@pytest.mark.parametrize("grad_scale", [0.01, 50.0])  # global norm below / above 5
def test_optimizer_update_matches_optax(solver, grad_scale):
    """Three updates on identical gradients, compared update by update
    (Adam's first update is lr * sign(g), so the params alone would only
    test rounding)."""
    cfg = __graft_entry__._flagship(shrink=16)[0]
    cfg.SOLVER.TYPE = solver
    rng = np.random.RandomState(13)
    shapes = {"a": (64, 32), "b": (32,), "c": (7, 3)}
    # zero parameters: the update is read off the new parameters exactly
    params = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    tx = jax_make_optimizer(cfg.SOLVER)
    jparams = _jax_tree(params)
    opt_state = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(_t(v)) for k, v in params.items()}
    opt = make_optimizer(cfg.SOLVER, list(tparams.values()))
    norms = []
    for step in range(3):
        grads = {k: (rng.randn(*s) * grad_scale).astype(np.float32) for k, s in shapes.items()}
        norms.append(float(optax.global_norm(_jax_tree(grads))))
        updates, opt_state = tx.update(_jax_tree(grads), opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        before = {k: p.detach().clone() for k, p in tparams.items()}
        for k, p in tparams.items():
            p.grad = _t(grads[k])
        clip_by_global_norm([p.grad for p in tparams.values()])
        for group in opt.param_groups:
            group["lr"] = schedules.learning_rate(cfg.SOLVER, step)
        opt.step()
        for k, p in tparams.items():
            _close_rel((p.detach() - before[k]).numpy(), updates[k], 1e-5, f"{k} step {step}")
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]),
                                       rtol=1e-6, atol=1e-6)
    assert all((n >= 5.0) == (grad_scale > 1) for n in norms)


def test_schedules_match_jax():
    cfg = __graft_entry__._flagship(shrink=16)[0]
    cfg.SOLVER.STEPS = [3, 7]
    for step in (0, 2, 3, 6, 7, 100):
        assert schedules.learning_rate(cfg.SOLVER, step) == float(
            jschedules.learning_rate(cfg.SOLVER, step))
        assert schedules.bn_momentum(cfg.SOLVER, step) == float(
            jschedules.bn_momentum(cfg.SOLVER, step))
    # AdaBound is ported (tests/test_torch_train_options.py holds it to optax)
    cfg.SOLVER.TYPE = "AdaBound"
    opt = make_optimizer(cfg.SOLVER, [torch.nn.Parameter(torch.zeros(1))])
    assert isinstance(opt, AdaBound) and opt.schedule(7) == schedules.learning_rate(cfg.SOLVER, 7)
    for step in (0, 3, 7, 100):
        assert schedules.piecewise_values(step, [3, 7], [1.0, 0.5, 0.25]) == float(
            jschedules.piecewise_values(step, [3, 7], [1.0, 0.5, 0.25]))


# ---------------------------------------------------- training, end to end

def test_a_few_bf16_steps_lower_the_total_loss():
    step, batch = train_entry(shrink=16, batch=2, device="cpu")
    state = step.args[0]
    assert state.model.training and state.step == 0
    before = {k: v.clone() for k, v in state.model.named_buffers() if k.endswith(".mean")}
    totals = []
    for _ in range(4):
        metrics = step(batch)
        assert {"cls", "offset", "angle", "corner", "vote", "total", "lr", "grad_norm",
                "param_norm"} <= set(metrics)
        assert all(np.isfinite(float(v)) for v in metrics.values())
        totals.append(float(metrics["total"]))
    assert state.step == 4
    assert totals[-1] < totals[0], totals
    moved = [k for k, v in state.model.named_buffers() if k in before and
             not torch.equal(v, before[k])]
    assert len(moved) == len(before)
