"""The KITTI training options no shipped config turns on, against the JAX
package on the CPU: the IoU head and its loss branch (`boxes_iou_matched`,
`iou_branch_loss`), 'Point' IoU assignment (`query_points_iou`), the
'Dist-Anchor' and 'Log-Anchor' box coders, AdaBound, and the augmentation
on the device (TPU.DEVICE_AUGMENT), stage by stage with the JAX module's
own random numbers, then one loss + gradient of the shrunk flagship with
all of them (`entry.TRAIN_OPTIONS`).

Inputs and weights are made with numpy from seeds. The port takes every
random draw as an argument (`train.device_aug.AugDraws`); the tests make
the JAX functions' draws from their keys, split as the JAX module splits
them, and hand them in.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssd3d.config import load_cfg as jax_load_cfg
from ssd3d.core import box_coders as jcoders
from ssd3d.core import iou as jiou
from ssd3d.models import build_detector as jax_build_detector
from ssd3d.models.heads import IoUHead as JaxIoUHead
from ssd3d.train import assigner as jassigner
from ssd3d.train import device_aug as jaug
from ssd3d.train import losses as jlosses
from ssd3d.train import schedules as jschedules
from ssd3d.train.train_step import TrainGraph as JaxTrainGraph
from ssd3d.train.train_step import make_optimizer as jax_make_optimizer
from ssd3d_torch.core import box_coders, iou
from ssd3d_torch.entry import FLAGSHIP_CFG, TRAIN_OPTIONS, flagship, synthetic_candidates
from ssd3d_torch.models.heads import IoUHead
from ssd3d_torch.train import assigner, device_aug, losses, schedules
from ssd3d_torch.train.adabound import AdaBound
from ssd3d_torch.train.train_step import (
    TrainGraph,
    apply_update,
    clip_by_global_norm,
    make_optimizer,
)
from ssd3d_torch.utils.convert import flax_to_state_dict

import test_torch_train as ttrain

# f32 results of the same arithmetic in another order (XLA contracts some
# multiply-adds into FMAs), as a share of the compared tensor's largest
# |value|
TOL = 1e-5
# losses of the shrunk flagship's step, as tests/test_torch_train.py holds
# its step (sums over a few hundred points in another order)
LOSS_RTOL = 1e-4
# The shrunk flagship's train-mode forward is ill-conditioned in f32
# (tests/test_torch_train.py, FLAGSHIP_GRAD_TOL): with this config its head
# outputs, the IoU head's included, part from JAX's by 1.3e-4 of their
# largest, and the IoU branch's loss, a mean of huber(predicted - target
# IoU) over few positives, by 1.3e-4 relative (measured). It is held within
# AUG_LOSS_RTOL, as is every loss of the step with the port's own
# augmentation on JAX's draws, whose points part from JAX's by f32 rounding
# (~1e-7 relative: XLA contracts the rotation's multiply-adds).
AUG_LOSS_RTOL = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= tol * max(np.abs(want).max(), 1e-30), (what, err, np.abs(want).max())


def _boxes(rng, n):
    ctr = rng.uniform(-15, 15, (n, 3))
    ctr[:, 1] = rng.uniform(0.5, 2.5, n)
    ctr[:, 2] = rng.uniform(5, 35, n)
    size = rng.uniform([3.0, 1.3, 1.4], [4.5, 1.8, 1.9], (n, 3))
    ry = rng.uniform(-np.pi, np.pi, (n, 1))
    return np.concatenate([ctr, size, ry], 1).astype(np.float32)


def _jitter(rng, boxes, scale=0.5):
    out = boxes.copy()
    out[..., 0:3] += rng.uniform(-scale, scale, boxes[..., 0:3].shape)
    out[..., 3:6] *= rng.uniform(0.8, 1.2, boxes[..., 3:6].shape)
    out[..., 6] += rng.uniform(-0.4, 0.4, boxes[..., 6].shape)
    return out.astype(np.float32)


# --------------------------------------------------------------- IoU head

@pytest.mark.parametrize("train", [False, True])
def test_iou_head_matches_jax(train):
    rng = np.random.RandomState(0)
    feats = rng.randn(2, 50, 24).astype(np.float32)
    jhead = JaxIoUHead(mlp=(16,), cls_channels=3, bn=True)
    shapes = jax.eval_shape(lambda f: jhead.init(jax.random.PRNGKey(0), f, False),
                            jnp.asarray(feats))
    variables = ttrain._fill(shapes, 1)
    if train:
        want, moved = jhead.apply(variables, jnp.asarray(feats), True, 0.9,
                                  mutable=["batch_stats"])
    else:
        want = jhead.apply(variables, jnp.asarray(feats), False)
    head = IoUHead(24, [16], 3)
    head.load_state_dict(flax_to_state_dict(variables), strict=True)
    head.train(train)
    got = head(_t(feats), 0.9)
    assert got.shape == (2, 50, 3)
    _close(got.detach().numpy(), want, what="iou")
    if train:
        for key, value in flax_to_state_dict({"batch_stats": moved["batch_stats"]}).items():
            _close(dict(head.named_buffers())[key].numpy(), value.numpy(), what=key)


def test_boxes_iou_matched_matches_jax():
    rng = np.random.RandomState(1)
    a = _boxes(rng, 300).reshape(3, 100, 7)
    b = _jitter(rng, a)
    want = jiou.boxes_iou_matched(jnp.asarray(a), jnp.asarray(b))
    got = iou.boxes_iou_matched(_t(a), _t(b))
    for g, w, name in zip(got, want, ("bev", "3d")):
        assert g.shape == (3, 100)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5, err_msg=name)
    assert 0.2 < float(got[1].mean()) < 0.9 and (got[1] > 0).all()
    # the pairs are the diagonal of the full matrices
    full = iou.boxes_iou_bev_3d(_t(a[0]), _t(b[0]))
    np.testing.assert_allclose(torch.diagonal(full[1]).numpy(), got[1][0].numpy(), atol=1e-6)


def test_bev_rects_overlap_matches_jax():
    rng = np.random.RandomState(2)
    a, b = _boxes(rng, 60), _boxes(rng, 50)
    a[:, 0:3] *= 0.3  # crowd them: about half the pairs overlap
    b[:, 0:3] *= 0.3
    want = np.asarray(jiou.bev_rects_overlap(jnp.asarray(a), jnp.asarray(b)))
    got = iou.bev_rects_overlap(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.05 < want.mean() < 0.95
    batched = iou.bev_rects_overlap(_t(np.stack([a, b[:10].repeat(6, 0)])),
                                    _t(np.stack([b, b])))
    np.testing.assert_array_equal(batched[0].numpy(), want)


def _assigned(seed, n=200, cls=("Car", "Pedestrian"), method="Dist-Anchor"):
    """Points around three GT boxes a scan, their anchors, and the JAX
    assigner's Mask targets."""
    rng = np.random.RandomState(seed)
    gt = np.zeros((2, 4, 7), np.float32)
    gt[:, :3] = _boxes(rng, 6).reshape(2, 3, 7)
    labels = (gt.any(-1)).astype(np.int32)
    labels[:, 1] = 2
    base = (gt[:, rng.randint(0, 3, n), :3] + rng.randn(2, n, 3) * [1.2, 0.5, 1.2]).astype(
        np.float32)
    anchors = np.asarray(jcoders.AnchorGenerator("KITTI", cls, method)(jnp.asarray(base)))
    jcfg = jassigner.AssignerConfig(method="Mask", iou_sample_type="3D", minibatch_size=-1,
                                    positive_ratio=0.5, pos_iou=0.3, neg_iou=0.2,
                                    effective_sample_range=10.0)
    targets = _np(jassigner.assign_targets(jcfg, jax.random.PRNGKey(0), jnp.asarray(base),
                                           jnp.asarray(anchors), jnp.asarray(gt),
                                           jnp.asarray(labels)))
    return rng, gt, labels, base, anchors, targets


def test_iou_branch_loss_and_gradient_match_jax():
    rng, _, _, _, anchors, targets = _assigned(3)
    assert targets["pmask"].sum() > 10
    cfg_kw = dict(cls_loss_type="Is-Not", cls_activation="Sigmoid", num_classes=2,
                  num_angle_cls=12, iou_loss=True, reg_type="Dist-Anchor")
    pred = (rng.rand(2, anchors.shape[1], 2) * 2 - 1).astype(np.float32)

    def jloss(p):
        return jlosses.iou_branch_loss(jlosses.LossConfig(**cfg_kw), {"iou": p},
                                       jax.tree_util.tree_map(jnp.asarray, targets),
                                       jnp.asarray(anchors))

    want, want_grad = jax.value_and_grad(jloss)(jnp.asarray(pred))
    tpred = _t(pred).requires_grad_(True)
    got = losses.iou_branch_loss(losses.LossConfig(**cfg_kw), {"iou": tpred},
                                 {k: _t(v) for k, v in targets.items()}, _t(anchors))
    assert got.item() == pytest.approx(float(want), rel=1e-5)
    got.backward()
    _close(tpred.grad.numpy(), want_grad, what="grad")
    with pytest.raises(ValueError, match="anchor boxes"):
        losses.iou_branch_loss(losses.LossConfig(**cfg_kw), {"iou": tpred},
                               {k: _t(v) for k, v in targets.items()}, _t(anchors[..., :1, :3]))


def test_point_iou_assignment_matches_jax():
    """'Point' IoU_SAMPLE_TYPE: the membership-count IoU of each anchor box
    with its assigned GT box, gated by the 3D IoU; masks equal."""
    _, gt, labels, base, anchors, _ = _assigned(4)
    kw = dict(method="IoU", iou_sample_type="Point", minibatch_size=-1, positive_ratio=0.5,
              pos_iou=0.3, neg_iou=0.2, effective_sample_range=10.0)
    want = _np(jassigner.assign_targets(jassigner.AssignerConfig(**kw), jax.random.PRNGKey(0),
                                        jnp.asarray(base), jnp.asarray(anchors),
                                        jnp.asarray(gt), jnp.asarray(labels)))
    got = assigner.assign_targets(assigner.AssignerConfig(**kw), _t(base), _t(anchors), _t(gt),
                                  _t(labels))
    for key in ("pmask", "nmask", "gt_cls", "assigned_idx"):
        np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)
    assert want["pmask"].sum() > 0 and want["nmask"].sum() > 0


# ------------------------------------------------------------ box coders

@pytest.mark.parametrize("method", ["Dist-Anchor", "Log-Anchor"])
def test_anchor_coders_match_jax(method):
    """Encode GT boxes against the mean-size anchors and decode random head
    outputs as the JAX package does; decoding the encoded targets (their
    angle bin one-hot) gives the GT boxes back."""
    rng, gt, _, base, anchors, targets = _assigned(5, method=method)
    gt_boxes = targets["gt_boxes"]
    jcoder, coder = jcoders.BoxCoder(method, 12), box_coders.BoxCoder(method, 12)
    assert coder.reg_channels == jcoder.reg_channels == 6
    want = jcoder.encode(jnp.asarray(base), jnp.asarray(gt_boxes), jnp.asarray(anchors))
    got = coder.encode(_t(base), _t(gt_boxes), _t(anchors))
    _close(got[0].numpy(), want[0], what="target")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-5)
    shape = anchors.shape[:3]
    off = (rng.randn(*shape, 6) * 0.3).astype(np.float32)
    a_cls = rng.randn(*shape, 12).astype(np.float32)
    a_res = (rng.rand(*shape, 12) - 0.5).astype(np.float32)
    want_boxes = jcoder.decode(*[jnp.asarray(x) for x in (base, off, a_cls, a_res, anchors)])
    got_boxes = coder.decode(*[_t(x) for x in (base, off, a_cls, a_res, anchors)])
    _close(got_boxes.numpy(), want_boxes, what="decode")
    # the round trip: the encoded targets decode to the GT boxes
    onehot = np.eye(12, dtype=np.float32)[got[1].numpy()]
    res = onehot * got[2].numpy()[..., None]
    back = coder.decode(_t(base), got[0], _t(onehot), _t(res), _t(anchors)).numpy()
    np.testing.assert_allclose(back[..., :6], gt_boxes[..., :6], rtol=1e-5, atol=1e-4)
    turn = np.remainder(back[..., 6] - gt_boxes[..., 6] + np.pi, 2 * np.pi) - np.pi
    assert np.abs(turn).max() < 1e-4


# -------------------------------------------------------------- AdaBound

@pytest.mark.parametrize("grad_scale", [0.01, 50.0])  # global norm below / above 5
def test_adabound_matches_optax_over_five_steps(grad_scale):
    """Five updates on identical gradients, each held to the JAX transform
    (with the clip), across a learning-rate boundary at step 3, which the
    transform reads at its incremented count."""
    cfg = jax_load_cfg(str(FLAGSHIP_CFG), ["SOLVER.TYPE", "AdaBound", "SOLVER.STEPS", "[3]"])
    rng = np.random.RandomState(14)
    shapes = {"a": (64, 32), "b": (32,), "c": (7, 3)}
    # zero parameters: the update is read off the new parameters exactly
    params = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    tx = jax_make_optimizer(cfg.SOLVER)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(_t(v)) for k, v in params.items()}
    opt = make_optimizer(cfg.SOLVER, list(tparams.values()))
    assert isinstance(opt, AdaBound)
    for step in range(5):
        grads = {k: (rng.randn(*s) * grad_scale).astype(np.float32) for k, s in shapes.items()}
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), opt_state,
                                       jparams)
        jparams = optax.apply_updates(jparams, updates)
        before = {k: p.detach().clone() for k, p in tparams.items()}
        for k, p in tparams.items():
            p.grad = _t(grads[k])
        clip_by_global_norm([p.grad for p in tparams.values()])
        opt.step()
        for k, p in tparams.items():
            _close((p.detach() - before[k]).numpy(), updates[k], 1e-5, f"{k} step {step}")
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]),
                                       rtol=1e-6, atol=1e-6)
    assert opt.param_groups[0]["count"] == 5


# ------------------------------------------------ device augmentation

def _aug_scene(seed, n=256, g=8, k=5, p=16):
    """A scan of n points with three GT boxes (points inside them) in g
    slots, k crop candidates of p points (the second hits GT box 0, the
    last is invalid) and the road plane."""
    rng = np.random.RandomState(seed)
    gt = np.zeros((g, 7), np.float32)
    gt[:3] = _boxes(rng, 3) * [0.3, 1, 0.3, 1, 1, 1, 1] + [0, 0, 6, 0, 0, 0, 0]
    labels = np.zeros(g, np.int32)
    labels[:3] = 1
    pts = np.concatenate([(gt[rng.randint(0, 3, n), :3] + rng.randn(n, 3) * [1.0, 0.4, 1.0]),
                          rng.rand(n, 1)], 1).astype(np.float32)
    cand_boxes = _boxes(rng, k)
    cand_boxes[1, [0, 2]] = gt[0, [0, 2]] + 0.5
    cand_points = (cand_boxes[:, None, :3] + rng.randn(k, p, 3) * 0.5).astype(np.float32)
    cand_points = np.concatenate([cand_points, rng.rand(k, p, 1).astype(np.float32)], -1)
    valid = np.ones(k, bool)
    valid[-1] = False
    plane = np.float32([0.01, -1.0, 0.02, 1.6])
    return pts, gt, labels, cand_points, cand_boxes, np.ones(k, np.int32), valid, plane


def _keys(seed, count):
    return jax.random.split(jax.random.PRNGKey(seed), count)


def test_paste_gt_samples_matches_jax():
    scenes = [_aug_scene(s) for s in (6, 7)]
    keys = _keys(8, 2)
    want = [jaug.paste_gt_samples(key, *[jnp.asarray(x) for x in sc]) for key, sc in
            zip(keys, scenes)]
    n = scenes[0][0].shape[0]
    start, step = zip(*[[int(jax.random.randint(k, (), 0, hi)) for k, hi in
                         zip(jax.random.split(key), (n, n // 2))] for key in keys])
    stacked = [_t(np.stack(x)) for x in zip(*scenes)]
    got = device_aug.paste_gt_samples(*stacked, torch.tensor(start), torch.tensor(step))
    for i in range(2):
        _close(got[0][i].numpy(), want[i][0], what="points")
        _close(got[1][i].numpy(), want[i][1], what="boxes")
        np.testing.assert_array_equal(got[2][i].numpy(), np.asarray(want[i][2]))
    placed = (got[2].numpy() > 0).sum(1) - 3
    assert (placed > 0).all() and (placed < 4).all()  # some crops in, the colliding one out


@pytest.mark.parametrize("seed", [9, 10, 11])
def test_flip_noise_rotation_scale_match_jax(seed):
    pts, gt, *_ = _aug_scene(seed)
    r = _keys(seed, 4)
    perturb, std = (-np.pi / 3, np.pi / 3), (1.0, 1.0, 0.0)
    # flip
    want = jaug.flip_x(r[0], jnp.asarray(pts), jnp.asarray(gt))
    got = device_aug.flip_x(torch.tensor([float(jax.random.uniform(r[0]))]),
                            _t(pts)[None], _t(gt)[None])
    for g, w in zip(got, want):
        _close(g[0].numpy(), w, what="flip")
    # per-object noise
    want = jaug.per_object_noise(r[1], jnp.asarray(pts), jnp.asarray(gt),
                                 rotation_perturb=perturb, center_noise_std=std)
    rl, rr, _ = jax.random.split(r[1], 3)
    loc = np.asarray(jax.random.normal(rl, (8, 16, 3)))
    rot = np.asarray(jax.random.uniform(rr, (8, 16)))
    got = device_aug.per_object_noise(_t(pts)[None], _t(gt)[None], _t(loc)[None],
                                      _t(rot)[None], perturb, std)
    _close(got[0][0].numpy(), want[0], what="noise points")
    _close(got[1][0].numpy(), want[1], what="noise boxes")
    assert not np.allclose(np.asarray(want[1])[:3], gt[:3])  # the boxes moved
    # global rotation and scale
    for jfn, tfn, arg in ((jaug.global_rotation, device_aug.global_rotation, np.pi / 4),
                          (jaug.global_scale, device_aug.global_scale, 0.1)):
        key = r[2] if jfn is jaug.global_rotation else r[3]
        want = jfn(key, jnp.asarray(pts), jnp.asarray(gt), arg)
        got = tfn(torch.tensor([float(jax.random.uniform(key))]), _t(pts)[None], _t(gt)[None],
                  arg)
        for g, w in zip(got, want):
            _close(g[0].numpy(), w, what=jfn.__name__)


def jax_draws(rng, bs: int, n: int, g: int) -> device_aug.AugDraws:
    """The draws `ssd3d.train.device_aug.augment_batch(rng, ...)` makes:
    a key a scan, split in six, the paste's in two, the noise's in three."""
    out = {k: [] for k in ("paste_start", "paste_step", "flip", "choice", "noise_loc",
                           "noise_rot", "rotation", "scale")}
    for key in jax.random.split(rng, bs):
        r = jax.random.split(key, 6)
        r_start, r_step = jax.random.split(r[0])
        rl, rr, _ = jax.random.split(r[3], 3)
        for name, value in (("paste_start", jax.random.randint(r_start, (), 0, n)),
                            ("paste_step", jax.random.randint(r_step, (), 0, n // 2)),
                            ("flip", jax.random.uniform(r[1])),
                            ("choice", jax.random.uniform(r[2], (3,))),
                            ("noise_loc", jax.random.normal(rl, (g, device_aug.NUM_TRY, 3))),
                            ("noise_rot", jax.random.uniform(rr, (g, device_aug.NUM_TRY))),
                            ("rotation", jax.random.uniform(r[4])),
                            ("scale", jax.random.uniform(r[5]))):
            out[name].append(np.asarray(value))
    return device_aug.AugDraws(**{k: _t(np.stack(v)) for k, v in out.items()})


def test_augment_batch_matches_jax_with_its_own_draws():
    """The whole chain over four scans, each stage applied where JAX's own
    draws say so (PROB 0.5 each)."""
    cfg = jax_load_cfg(str(FLAGSHIP_CFG), ["TRAIN.AUGMENTATIONS.FLIP", "True"])
    scenes = [_aug_scene(s) for s in range(4)]
    keys = ("points", "gt_boxes", "gt_labels", "cand_points", "cand_boxes", "cand_labels",
            "cand_valid", "plane")
    batch = {k: np.stack(v) for k, v in zip(keys, zip(*scenes))}
    rng = jax.random.PRNGKey(12)
    want = jaug.augment_batch(rng, {k: jnp.asarray(v) for k, v in batch.items()},
                              cfg.TRAIN.AUGMENTATIONS)
    draws = jax_draws(rng, 4, 256, 8)
    got = device_aug.augment_batch({k: _t(v) for k, v in batch.items()},
                                   cfg.TRAIN.AUGMENTATIONS, draws)
    _close(got["points"].numpy(), want["points"], what="points")
    _close(got["gt_boxes"].numpy(), want["gt_boxes"], what="boxes")
    np.testing.assert_array_equal(got["gt_labels"].numpy(), np.asarray(want["gt_labels"]))
    applied = draws.choice.numpy() <= 0.5
    assert applied.any(0).all() and not applied.all()  # each stage on some scans, not all


def test_draw_gives_every_draw_its_shape_and_range():
    gen = torch.Generator().manual_seed(0)
    d = device_aug.draw(gen, 3, 1024, 8, "cpu")
    assert d.noise_loc.shape == (3, 8, device_aug.NUM_TRY, 3)
    assert d.noise_rot.shape == (3, 8, device_aug.NUM_TRY) and d.choice.shape == (3, 3)
    assert ((0 <= d.paste_start) & (d.paste_start < 1024)).all()
    assert ((0 <= d.paste_step) & (d.paste_step < 512)).all()
    again = device_aug.draw(torch.Generator().manual_seed(0), 3, 1024, 8, "cpu")
    assert torch.equal(d.noise_loc, again.noise_loc)


# ------------------------------------------ the shrunk flagship, all options

@pytest.fixture(scope="module")
def options_step():
    """One JAX loss + gradient of the shrunk flagship (1,024 points, batch
    2, f32) with TRAIN_OPTIONS, its augmentation fed 15 crops of 32 points
    a scan, and the port's on the same weights, batch and draws."""
    shrink = 16
    cfg = jax_load_cfg(str(FLAGSHIP_CFG), TRAIN_OPTIONS + ["TPU.COMPUTE_DTYPE", "float32"])
    for layer in cfg.MODEL.NETWORK.FIRST_STAGE.ARCHITECTURE:
        layer[6] = [r if r == -1 else r // shrink for r in layer[6]]
        layer[8] = [p if p == -1 else p // shrink for p in layer[8]]
    cfg.MODEL.POINTS_NUM_FOR_TRAINING //= shrink
    n = cfg.MODEL.POINTS_NUM_FOR_TRAINING
    jmodel, jspec = jax_build_detector(cfg)
    jgraph = JaxTrainGraph.build(cfg, jmodel, jspec)
    assert jgraph.aug_cfg is not None and jspec.has_iou_head
    data = ttrain._scene_batch(11, n, inside_frac=0.3)
    data.update(synthetic_candidates(2, 15, 32, seed=11))
    shapes = jax.eval_shape(lambda p: jmodel.init(jax.random.PRNGKey(0), p, False),
                            jnp.asarray(data["points"][:1]))
    variables = ttrain._fill(shapes, 12)
    bn_m = float(jschedules.bn_momentum(cfg.SOLVER, 0))
    rng = jax.random.PRNGKey(1)
    fn = jax.jit(jax.value_and_grad(jgraph.compute_losses, has_aux=True))
    (total, (loss_dict, _)), grads = fn(variables["params"], variables["batch_stats"],
                                        jax.tree_util.tree_map(jnp.asarray, data), rng, bn_m)
    want = dict(total=float(total), losses=_np(loss_dict),
                grads=flax_to_state_dict({"params": _np(grads)}))

    rng_aug = jax.random.split(rng)[1]
    augmented = _np(jaug.augment_batch(rng_aug, jax.tree_util.tree_map(jnp.asarray, data),
                                       cfg.TRAIN.AUGMENTATIONS))

    pcfg, model, spec, _ = flagship(shrink=shrink, compute_dtype="float32", device="cpu",
                                    opts=TRAIN_OPTIONS)
    graph = TrainGraph.build(pcfg, model, spec)
    state = graph.init_state()
    pbn_m = schedules.bn_momentum(pcfg.SOLVER, 0)
    # the whole step, the augmentation on JAX's draws: its points part from
    # JAX's by rounding, which the step amplifies
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    draws = jax_draws(rng_aug, 2, n, data["gt_boxes"].shape[1])
    with torch.no_grad():
        _, own_aug = graph.compute_losses({k: _t(v) for k, v in data.items()}, pbn_m, draws)
    # the step after the augmentation, on JAX's augmented batch
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    unaugmented = dataclasses.replace(graph, aug_cfg=None)
    got_total, got_losses = unaugmented.compute_losses(
        {k: _t(v) for k, v in augmented.items()}, pbn_m)
    got_total.backward()
    return want, got_total, got_losses, model, state, own_aug


def test_train_options_losses_match_jax(options_step):
    """On JAX's augmented batch every loss within LOSS_RTOL (the IoU
    branch's within AUG_LOSS_RTOL); with the port's own augmentation on
    JAX's draws each within AUG_LOSS_RTOL."""
    want, total, loss_dict, _, _, own_aug = options_step
    assert set(loss_dict) == set(own_aug) == set(want["losses"]) == {
        "cls", "offset", "angle", "corner", "vote", "iou"}
    for key, value in loss_dict.items():
        rtol = AUG_LOSS_RTOL if key == "iou" else LOSS_RTOL
        assert value.item() == pytest.approx(float(want["losses"][key]), rel=rtol), key
        assert value.item() > 0, key  # positives exist, so every loss is live
        assert own_aug[key].item() == pytest.approx(float(want["losses"][key]),
                                                    rel=AUG_LOSS_RTOL), key
    assert total.item() == pytest.approx(want["total"], rel=LOSS_RTOL)


def test_train_options_gradients_match_jax(options_step):
    """Each leaf's gradient within tests/test_torch_train.py's bound for the
    flagship's step (FLAGSHIP_GRAD_TOL, in norm), the IoU head's included;
    then an AdaBound update from them."""
    want, _, _, model, state, _ = options_step
    grads = {name: p.grad for name, p in model.named_parameters()}
    assert set(grads) == set(want["grads"])
    assert any(k.startswith("iou_head.") for k in grads)
    for name, g in grads.items():
        ref = want["grads"][name].double()
        if name.endswith("conv.bias") and name[:-9] + "bn.scale" in grads:
            ref = want["grads"][name[:-4] + "kernel"].double()
        err = float((g.double() - want["grads"][name].double()).norm() / ref.norm())
        assert err <= ttrain.FLAGSHIP_GRAD_TOL, (name, err)
    assert isinstance(state.optimizer, AdaBound)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    apply_update(state, 0.002)
    moved = [k for k, p in model.named_parameters() if not torch.equal(p, before[k])]
    assert len(moved) > 100 and state.step == 1
