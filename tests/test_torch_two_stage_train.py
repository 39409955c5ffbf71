"""PointRCNN's stage-wise training: the port's ops, losses and train steps
against the JAX package on the CPU, at the in-repo tiny configs
(`configs/kitti/pointrcnn/pointrcnn_tiny_stage{1,2}.yaml`) at f32.

Inputs and weights are made with numpy from a seed and handed to both
packages. Stage 2's minibatch subsampling takes the JAX step's own random
numbers: the same keys `assign_targets` splits (the step's rng folded by the
step, split per stage, per scan, then into the positive and negative draw),
drawn with `jax.random.uniform` and handed to the port as `uniforms`.

Each stage's step is compared from the same state, as
`tests/test_torch_trainer.py` compares the 3DSSD trainers: the loss dict,
then the state after the step leaf by leaf (Adam's moments, the BatchNorm
statistics, the parameters whose gradient is resolved). Stage 1 is held to
the JAX step at f32; stage 2 to the JAX step run in float64 from the same
state on the same draws (`_jax_float64_step`).
"""

from __future__ import annotations

import contextlib
import dataclasses
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssd3d.config import load_cfg as jax_load_cfg
from ssd3d.core import box_coders as jcoders
from ssd3d.models.api import build_pipeline as jax_build_pipeline
from ssd3d.nn import layers as jlayers
from ssd3d.models import two_stage as jtwo_stage
from ssd3d.nn import modules as jmodules
from ssd3d.ops import grouping as jgrouping
from ssd3d.ops import sampling as jsampling
from ssd3d.train import assigner as jassigner
from ssd3d.train import losses as jlosses
from ssd3d.train.train_step import TrainState as JaxTrainState
from ssd3d_torch import config
from ssd3d_torch.core import box_coders
from ssd3d_torch.entry import synthetic_scenes
from ssd3d_torch.models.api import build_pipeline
from ssd3d_torch.ops import grouping, sampling
from ssd3d_torch.train import assigner, losses
from ssd3d_torch.train.train_step import trained_parameters
from ssd3d_torch.utils.convert import flax_to_state_dict

REPO = Path(__file__).resolve().parents[1]
TINY = str(REPO / "configs/kitti/pointrcnn/pointrcnn_tiny_stage{}.yaml")
# losses of random head outputs: the same arithmetic in another order
LOSS_RTOL = 1e-5
# one f32 step from the same state: each loss within this share of the
# largest loss of the dict
STEP_LOSS_TOL = 1e-4
# the state after the step, as tests/test_torch_trainer.py holds it: BatchNorm
# statistics within STAT_RTOL of the leaf's largest |value|; Adam's moments
# within MOMENT_RTOL in norm, leaf by leaf; parameters, where the gradient
# is at least RESOLVED of its leaf's largest, within PARAM_TOL * lr. A leaf
# whose gradient is at rounding level (ROUNDING_LEVEL of the largest) on
# both sides is left out.
STAT_RTOL = 1e-4
MOMENT_RTOL = 2e-2
RESOLVED = 0.1
PARAM_TOL = 1e-2
ROUNDING_LEVEL = 5e-5
# Proposals of a seeded RPN rarely overlap a car by the tiny config's 0.45:
# the step test takes 128 proposals and lowers the stage-2 thresholds, so
# that each scan of its batch has proposals with targets (scan 0 negatives,
# scan 1 positives) and every stage-2 loss is live.
STEP_OPTS = ["TPU.COMPUTE_DTYPE", "float32",
             "MODEL.FIRST_STAGE.MAX_OUTPUT_NUM", "128",
             "MODEL.SECOND_STAGE.CLASSIFICATION_POS_IOU", "0.2",
             "MODEL.SECOND_STAGE.CLASSIFICATION_NEG_IOU", "0.15"]
PRE_TOPK = 512  # below the 2,048 candidates: the proposal prefilter runs
BATCH = 2


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _boxes(rng, n):
    ctr = rng.uniform(-20, 20, (n, 3))
    ctr[:, 1] = rng.uniform(0.5, 2.5, n)
    ctr[:, 2] = rng.uniform(5, 40, n)
    size = rng.uniform(0.5, 5.0, (n, 3))
    ry = rng.uniform(-np.pi, np.pi, (n, 1))
    return np.concatenate([ctr, size, ry], 1).astype(np.float32)


# ------------------------------------------------------------- ops

def test_query_boxes_3d_mask_matches_jax():
    rng = np.random.RandomState(2)
    boxes = _boxes(rng, 2 * 40).reshape(2, 40, 7)
    # a third of the points inside boxes, on their faces too
    pts = rng.uniform(-20, 20, (2, 600, 3)).astype(np.float32)
    pts[:, :200] = boxes[:, :20, None, :3].repeat(10, 1).reshape(2, 200, 3)
    want = np.asarray(jgrouping.query_boxes_3d_mask(jnp.asarray(pts), jnp.asarray(boxes)))
    got = grouping.query_boxes_3d_mask(_t(pts), _t(boxes))
    assert got.dtype == torch.int32 and got.shape == (2, 40, 600)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size


@pytest.mark.parametrize("hits", [40, 5, 0])  # more than k, fewer, none
def test_gather_by_mask_matches_jax(hits):
    rng = np.random.RandomState(hits)
    pts = rng.randn(3, 100, 7).astype(np.float32)
    mask = np.zeros((3, 100), np.float32)
    for b in range(3):
        mask[b, rng.choice(100, hits, replace=False)] = 1.0
    want = np.asarray(jsampling.gather_by_mask(jnp.asarray(pts), jnp.asarray(mask), 16))
    got = sampling.gather_by_mask(_t(pts), _t(mask), 16)
    np.testing.assert_array_equal(got.numpy(), want)
    # integer rows gather as they are
    ids = np.broadcast_to(np.arange(100, dtype=np.int32), (3, 100))[..., None]
    got_ids = sampling.gather_by_mask(_t(ids), _t(mask), 16)[..., 0]
    np.testing.assert_array_equal(got.numpy(), pts[np.arange(3)[:, None], got_ids.numpy()])


# ---------------------------------------------------------- losses

def _stage_inputs(stage: int, seed: int, n: int = 160):
    """Random head outputs of a Bin-Anchor stage, the JAX assigner's
    targets for them, and the anchors: stage 1 Mask-assigned mean-size
    anchors, stage 2 IoU-assigned proposals (one anchor a point)."""
    cfg = jax_load_cfg(TINY.format(2))
    sc = cfg.MODEL.FIRST_STAGE if stage == 1 else cfg.MODEL.SECOND_STAGE
    rng = np.random.RandomState(seed)
    gt = np.zeros((2, 4, 7), np.float32)
    gt[:, :3] = _boxes(rng, 6).reshape(2, 3, 7)
    gt[:, :3, 3:6] = [3.9, 1.6, 1.6]
    labels = (gt.any(-1)).astype(np.int32)
    # points around the boxes' centres, some inside
    base = (gt[:, rng.randint(0, 3, n), :3] + rng.randn(2, n, 3) * [1.5, 0.6, 1.5]).astype(
        np.float32)
    if stage == 1:
        anchors = np.asarray(jcoders.AnchorGenerator("KITTI", ("Car",), "Bin-Anchor")(
            jnp.asarray(base)))
    else:
        prop = np.concatenate([base, np.broadcast_to([3.9, 1.6, 1.6], (2, n, 3)),
                               rng.uniform(-0.3, 0.3, (2, n, 1))], -1).astype(np.float32)
        prop[..., 1] += 0.8
        anchors = prop[:, :, None, :]
    jcfg = jassigner.AssignerConfig.from_cfg(sc)
    jcfg = jassigner.AssignerConfig(jcfg.method, jcfg.iou_sample_type, -1, 0.5, 0.3, 0.2,
                                    jcfg.effective_sample_range)
    targets = _np(jassigner.assign_targets(jcfg, jax.random.PRNGKey(0), jnp.asarray(base),
                                           jnp.asarray(anchors), jnp.asarray(gt),
                                           jnp.asarray(labels)))
    nb = sc.REGRESSION_METHOD.BIN_CLASS_NUM
    ch = 2 if sc.CLS_ACTIVATION == "Softmax" else 1
    outputs = {"base_xyz": base,
               "cls": rng.randn(2, n, ch).astype(np.float32),
               "offset": rng.randn(2, n, 1, 4 * nb + 4).astype(np.float32),
               "angle_cls": rng.randn(2, n, 1, 12).astype(np.float32),
               "angle_res": (rng.rand(2, n, 1, 12) - 0.5).astype(np.float32)}
    return cfg, ("FIRST_STAGE" if stage == 1 else "SECOND_STAGE"), outputs, targets, anchors, base


@pytest.mark.parametrize("stage", [1, 2])
def test_offset_loss_bin_and_stage_losses_match_jax(stage):
    cfg, name, outputs, targets, anchors, base = _stage_inputs(stage, 10 + stage)
    assert targets["pmask"].sum() > 0 and targets["nmask"].sum() > 0
    sc = cfg.MODEL[name]
    jcfg = jlosses.LossConfig.from_cfg(cfg, name)
    jcoder = jcoders.BoxCoder("Bin-Anchor", 12, sc.REGRESSION_METHOD.HALF_BIN_SEARCH_RANGE,
                              sc.REGRESSION_METHOD.BIN_CLASS_NUM)

    def jax_losses(out):
        return jlosses.compute_stage_losses(jcfg, jcoder, dict(outputs, **out),
                                            jax.tree_util.tree_map(jnp.asarray, targets),
                                            jnp.asarray(anchors), jnp.asarray(base))

    keys = ("cls", "offset", "angle_cls", "angle_res")
    jout = {k: jnp.asarray(outputs[k]) for k in keys}
    want = _np(jax.jit(jax_losses)(jout))
    want_grads = _np(jax.jit(jax.grad(lambda o: sum(jax_losses(o).values())))(jout))

    tcfg = losses.LossConfig.from_cfg(config.load_cfg(TINY.format(2)), name)
    coder = box_coders.BoxCoder("Bin-Anchor", 12, sc.REGRESSION_METHOD.HALF_BIN_SEARCH_RANGE,
                                sc.REGRESSION_METHOD.BIN_CLASS_NUM)
    tout = {k: _t(outputs[k]).requires_grad_(True) for k in keys}
    got = losses.compute_stage_losses(tcfg, coder, dict(base_xyz=_t(base), **tout),
                                      {k: _t(v) for k, v in targets.items()}, _t(anchors),
                                      _t(base))
    assert set(got) == set(want) == ({"cls", "offset", "angle", "corner"} if stage == 2
                                     else {"cls", "offset", "angle"})
    for key, value in got.items():
        assert value.item() == pytest.approx(float(want[key]), rel=LOSS_RTOL), key
    want_offset = float(jlosses.offset_loss_bin(
        jcfg, jout, dict(targets, gt_offset=np.asarray(jcoder.encode(
            jnp.asarray(base), jnp.asarray(targets["gt_boxes"]), jnp.asarray(anchors))[0]))))
    assert got["offset"].item() == pytest.approx(want_offset, rel=LOSS_RTOL)
    sum(got.values()).backward()
    for key in keys:
        g, w = tout[key].grad.numpy(), want_grads[key]
        assert np.abs(g - w).max() <= LOSS_RTOL * np.abs(w).max(), key


# ------------------------------------------------------- freezing

def test_trained_parameters_follow_the_prefix():
    cfg = config.load_cfg(TINY.format(2))
    pipe = build_pipeline(cfg, device="cpu")
    names = {id(p): n for n, p in pipe.model.named_parameters()}
    picked = [names[id(p)] for p in trained_parameters(pipe.model, ("rcnn", "roi"))]
    assert picked and all(n.split(".")[0] in ("roi_pool", "rcnn_backbone", "rcnn_head")
                          for n in picked)
    assert len(picked) == sum(n.startswith(("rcnn", "roi")) for n in names.values())
    assert len(trained_parameters(pipe.model)) == len(names)
    assert pipe.graph.freeze_rpn and pipe.graph.loss_prefixes == ("loss_stage1",)
    first = build_pipeline(config.load_cfg(TINY.format(1)), device="cpu").graph
    assert not first.freeze_rpn and first.only_first_stage


# ------------------------------------------------- one step per stage

def _fill(shapes, seed):
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            lim = np.sqrt(6.0 / (s.shape[0] + s.shape[1]))
            return rng.uniform(-lim, lim, s.shape)
        if name in ("scale", "var"):
            return rng.uniform(0.8, 1.2, s.shape)
        return rng.uniform(-0.1, 0.1, s.shape)

    return jax.tree_util.tree_map_with_path(lambda p, s: leaf(p, s).astype(np.float32), shapes)


def _jax_uniforms(rng, step: int, bs: int, n: int) -> np.ndarray:
    """The draws of the JAX step's stage-2 subsampling: [bs, 2, n]."""
    _, rng2 = jax.random.split(jax.random.fold_in(rng, step))
    return np.stack([np.stack([np.asarray(jax.random.uniform(k, (n,)))
                               for k in jax.random.split(r)])
                     for r in jax.random.split(rng2, bs)])


def _leaves(model: torch.nn.Module, opt) -> dict:
    out = dict(model.state_dict())
    for group in opt.param_groups:
        for p in group["params"]:
            name = next(n for n, q in model.named_parameters() if q is p)
            for moment in ("mu", "nu"):
                out[f"{moment}:{name}"] = opt.state[p][moment]
    return out


def _jax_leaves(state) -> dict:
    adam = [s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(adam) == 1
    out = flax_to_state_dict({"params": _np(state.params), "batch_stats": _np(state.batch_stats)})
    def prune(tree):  # frozen leaves hold no moments (optax.MaskedNode)
        if isinstance(tree, optax.MaskedNode):
            return None
        if not isinstance(tree, dict):
            return np.asarray(tree)
        kept = {k: prune(v) for k, v in tree.items()}
        return {k: v for k, v in kept.items() if v is not None and not (isinstance(v, dict)
                                                                      and not v)}

    for moment in ("mu", "nu"):
        tree = prune(dict(getattr(adam[0], moment)))
        out.update({f"{moment}:{k}": v for k, v in flax_to_state_dict({"params": tree}).items()})
    return out


def _port_step(stage, variables, data, uniforms, jrpn=None, opts=STEP_OPTS):
    """One f32 step of the port from the flax `variables` at the tiny
    config of `stage` with `opts`. Stage 2 takes the JAX RPN's outputs
    `jrpn` (its own RPN runs for the statistics).
    -> (metrics, state leaves after, stage-2 (proposals, targets))."""
    pipe = build_pipeline(config.load_cfg(TINY.format(stage), opts),
                          nms_pre_topk=PRE_TOPK, device="cpu")
    pipe.model.load_state_dict(flax_to_state_dict(variables), strict=True)
    graph = pipe.graph
    state = graph.init_state()
    batch = {k: _t(v) for k, v in data.items()}
    minibatch = None
    with contextlib.ExitStack() as stack:
        if jrpn is not None:
            real_rpn = pipe.model.rpn

            def rpn_with_jax_outputs(points, bn_momentum=0.9):
                real_rpn(points, bn_momentum)
                return dict(jrpn)

            stack.enter_context(mock.patch.object(pipe.model, "rpn", rpn_with_jax_outputs))
            rpn = {k: v.detach() if torch.is_tensor(v) else v for k, v in jrpn.items()}
            minibatch = graph.stage2_targets(rpn, batch["gt_boxes"], batch["gt_labels"],
                                             uniforms)
        metrics = graph.train_step(state, batch, uniforms=uniforms)
    return ({k: float(v) for k, v in metrics.items()}, _leaves(pipe.model, state.optimizer),
            minibatch)


class _Float64For32:
    """`jax.numpy` with `float32` read as `float64`: in the float64 run, the
    JAX BatchNorm (`ssd3d/nn/layers.py`), which pins its statistics and
    affine to f32, computes them in float64."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


class _RpnOutputs:
    """The JAX model, but `apply(..., method="rpn")` returns `outputs` in
    place of the RPN's own (whose statistics still move)."""

    def __init__(self, model, outputs: dict):
        self.model, self.outputs = model, outputs

    def apply(self, variables, *args, method=None, **kwargs):
        out = self.model.apply(variables, *args, method=method, **kwargs)
        return (dict(self.outputs), out[1]) if method == "rpn" else out


@contextlib.contextmanager
def _float64():
    """JAX in float64, with the BatchNorm's f32 pin lifted and the
    subsampling draws `jax.random.uniform` makes kept at f32 (the f32 step's
    own numbers: under x64 its default would draw others)."""
    real_uniform = jax.random.uniform

    def uniform(key, shape=(), dtype=None, minval=0.0, maxval=1.0):
        return real_uniform(key, shape, jnp.float32 if dtype is None else dtype, minval, maxval)

    with jax.enable_x64(True), mock.patch.object(jlayers, "jnp", _Float64For32()), \
            mock.patch.object(jax.random, "uniform", uniform):
        yield


def _to64(tree):
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, jnp.float64) if np.issubdtype(np.asarray(x).dtype, np.floating)
        else jnp.asarray(x), tree)


class _F32Proposals:
    """The stage's spec, but `propose` returns `proposals` (the f32 step's)."""

    def __init__(self, spec, proposals):
        self.spec, self.proposals = spec, proposals

    def propose(self, outputs):
        return self.proposals

    def __getattr__(self, name):
        return getattr(self.spec, name)


def _f32_dfps(xyz, npoint, *args):
    """The JAX D-FPS on xyz rounded to f32: the f32 step's picks."""
    return jsampling.farthest_point_sample(xyz.astype(jnp.float32), npoint, *args)


def _f32_expand_boxes(boxes, context):
    """The pooler's grown boxes rounded to f32, as the f32 step rounds them."""
    return _EXPAND_BOXES(boxes, context).astype(jnp.float32).astype(boxes.dtype)


_EXPAND_BOXES = jtwo_stage.expand_boxes


def _jax_float64_step(jgraph, jpipe, variables, data, rng, jrpn: dict,
                      f32_lattice: bool = False):
    """The JAX stage-2 step in float64 from the f32 `variables` on `data`,
    stage 2 fed the f32 RPN outputs `jrpn` (its RPN runs for the statistics),
    with the f32 step's draws -> (leaves before, leaves after, metrics,
    its minibatch). The RCNN's discrete decisions take the float64 values,
    but with `f32_lattice` (STD's voxel centres, whose distances tie) the
    proposals are the f32 step's, the pooler's grown boxes are rounded to
    f32 as the f32 step rounds them, and each D-FPS picks on its xyz rounded
    to f32: where the grid is a power of two (the tests' 4 x 4 x 4) the
    float64 lattice, dyadic unit centres times the f32 sizes, is then
    exact, and rounded to f32 it is the f32 step's lattice, so its picks
    are the f32 step's, where float64 rounding would break the ties
    otherwise."""
    proposals = tuple(jgraph.rpn_spec.propose(jrpn)) if f32_lattice else None
    with _float64(), contextlib.ExitStack() as stack:
        params = _to64(variables)
        graph = dataclasses.replace(jgraph, model=_RpnOutputs(jpipe.model, _to64(jrpn)))
        if f32_lattice:
            graph = dataclasses.replace(graph, rpn_spec=_F32Proposals(jgraph.rpn_spec,
                                                                      _to64(proposals)))
            stack.enter_context(mock.patch.object(jmodules, "farthest_point_sample", _f32_dfps))
            stack.enter_context(mock.patch.object(jtwo_stage, "expand_boxes", _f32_expand_boxes))
        state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params["params"],
                              batch_stats=params["batch_stats"],
                              opt_state=graph.tx.init(params["params"]))
        after, metrics = jax.jit(graph.train_step)(state, _to64(data), rng)
        minibatch = _jax_minibatch(graph, _to64(jrpn), data, rng)
        return _jax_leaves(state), _jax_leaves(after), _np(metrics), minibatch


@pytest.fixture(scope="module")
def stage_steps():
    """{stage: the JAX f32 step's state leaves before and after and metrics;
    `ref`, what the port is held to (stage 1 the JAX f32 step, stage 2 the
    JAX float64 step); the port's state before, leaves after and metrics;
    for stage 2 also both packages' minibatches} for one f32 step of each
    stage from the same seeded state on the same batch."""
    data = synthetic_scenes(BATCH, 2048, seed=5)
    return {stage: stage_run(stage, data) for stage in (1, 2)}


def stage_run(stage: int, data: dict, opts=STEP_OPTS, f32_lattice: bool = False) -> dict:
    """One f32 step of the tiny config of `stage` with `opts` in both
    packages from the same seeded state on `data` (a `stage_steps` run);
    `f32_lattice` as `_jax_float64_step` takes it."""
    jcfg = jax_load_cfg(TINY.format(stage), opts)
    jpipe = jax_build_pipeline(jcfg, nms_pre_topk=PRE_TOPK)
    jgraph = jpipe.graph
    shapes = jax.eval_shape(
        lambda p: jpipe.model.init(jax.random.PRNGKey(0), p, False, 0.9,
                                   rpn_spec=jgraph.rpn_spec),
        jnp.asarray(data["points"][:1]))
    variables = _fill(shapes, 21)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=jgraph.tx.init(variables["params"]))
    rng = jax.random.PRNGKey(5)
    jafter, jmetrics = jax.jit(jgraph.train_step)(
        jstate, {k: jnp.asarray(v) for k, v in data.items()}, rng)
    run = dict(jax=(_jax_leaves(jstate), _jax_leaves(jafter), _np(jmetrics)),
               before=flax_to_state_dict(variables), lr=float(jmetrics["lr"]))
    if stage == 1:
        run["metrics"], run["after"], _ = _port_step(1, variables, data, None, opts=opts)
        run["ref"] = run["jax"]
    else:
        # the frozen RPN's outputs are data to stage 2: the port's RPN
        # runs (its statistics move) and stage 2 takes the JAX RPN's
        # outputs, so that the RCNN's discrete decisions (RoI members,
        # D-FPS picks of canonical points) see the same inputs. The two
        # RPNs part by ~5e-5 of the largest output (stage 1's test holds
        # them), which moves a proposal by ~1e-4 m: enough to flip a
        # D-FPS pick of the RCNN.
        jrpn = jax.jit(lambda v, p: jpipe.model.apply(
            v, p, True, 0.9, method="rpn", mutable=["batch_stats"])[0])(
            variables, jnp.asarray(data["points"]))
        uniforms = _t(_jax_uniforms(rng, 0, BATCH, jgraph.rpn_spec.max_output))
        run["metrics"], run["after"], run["minibatch"] = _port_step(
            2, variables, data, uniforms,
            {k: _t(v) if isinstance(v, jax.Array) else v for k, v in jrpn.items()},
            opts=opts)
        run["jax_minibatch"] = _jax_minibatch(jgraph, jrpn, data, rng)
        *run["ref"], run["ref_minibatch"] = _jax_float64_step(
            jgraph, jpipe, variables, data, rng, jrpn, f32_lattice)
    return run


def _jax_minibatch(jgraph, rpn: dict, data: dict, rng) -> dict:
    """The JAX step's stage-2 proposals and targets, from the same RPN
    outputs, as `TwoStageGraph.compute_losses` computes them."""
    from ssd3d.core.geometry import boxes_bottom_to_center
    from ssd3d.models.two_stage import expand_boxes
    from ssd3d.train.two_stage_step import gather_tree_by_mask

    _, rng2 = jax.random.split(jax.random.fold_in(rng, 0))
    proposals, _, prop_valid = jgraph.rpn_spec.propose(rpn)
    ctx = jgrouping.query_boxes_3d_mask(rpn["base_xyz"],
                                        expand_boxes(proposals, jgraph.pool_context)).max(-1)
    valid = (ctx.astype(jnp.float32) * prop_valid.astype(jnp.float32))[..., None]
    targets = jassigner.assign_targets(
        jgraph.assigner_2, rng2, boxes_bottom_to_center(proposals)[..., 0:3],
        proposals[:, :, None, :], jnp.asarray(data["gt_boxes"]), jnp.asarray(data["gt_labels"]),
        valid_mask=valid)
    sel = (jnp.max(targets["pmask"] + targets["nmask"], axis=-1) > 0).astype(jnp.float32)
    return _np(gather_tree_by_mask(
        {"proposals": proposals, "pmask": targets["pmask"], "nmask": targets["nmask"],
         "gt_cls": targets["gt_cls"][..., None], "gt_boxes": targets["gt_boxes"]},
        sel, jgraph.minibatch))


@pytest.mark.parametrize("stage", [1, 2])
def test_stage_step_losses_match_jax(stage_steps, stage, record_property):
    check_step_losses(stage_steps[stage], stage, record_property)


def check_step_losses(run: dict, stage: int, record_property, tol: float = STEP_LOSS_TOL) -> None:
    """A stage's step losses (a run of `stage_steps`) against its reference,
    each within `tol` of the largest loss, and stage 2's minibatch against
    the JAX step's."""
    want, got = run["ref"][2], run["metrics"]
    assert set(got) == set(want)
    losses_ = [k for k in want if k.startswith("loss_stage")]
    assert {k.split("/")[0] for k in losses_} == ({"loss_stage0"} if stage == 1
                                                   else {"loss_stage0", "loss_stage1"})
    largest = max(abs(float(want[k])) for k in losses_)
    for key in losses_:
        assert abs(got[key] - float(want[key])) <= tol * largest, (
            key, got[key], float(want[key]))
    trained = [k for k in losses_ if stage == 1 or k.startswith("loss_stage1/")]
    assert got["total"] == pytest.approx(sum(got[k] for k in trained), rel=1e-6)
    assert got["lr"] == pytest.approx(float(want["lr"]), rel=1e-7)
    if stage == 2:
        # how far each package's f32 step lies from the JAX float64 step
        for name, values in (("jax", run["jax"][2]), ("port", got)):
            record_property(f"{name}_f32_from_float64_over_largest_loss", max(
                abs(float(values[k]) - float(want[k])) for k in losses_) / largest)
        # the minibatch is the JAX step's, at f32 and at float64: proposals,
        # masks, classes and boxes
        props, mb = run["minibatch"]
        for jmb in (run["jax_minibatch"], run["ref_minibatch"]):
            np.testing.assert_allclose(props.numpy(), jmb["proposals"], rtol=1e-6, atol=1e-5)
            for key in ("pmask", "nmask", "gt_boxes"):
                np.testing.assert_array_equal(mb[key].numpy(), jmb[key], err_msg=key)
            np.testing.assert_array_equal(mb["gt_cls"].numpy(), jmb["gt_cls"][..., 0])
        # each scan's minibatch holds proposals with targets, positives and
        # negatives over the batch, and every stage-2 loss is live
        assert ((mb["pmask"] + mb["nmask"]).sum((1, 2)) > 0).all()
        assert mb["pmask"].sum() > 0 and mb["nmask"].sum() > 0
        assert all(got[k] > 0 for k in losses_ if k.startswith("loss_stage1/"))


@pytest.mark.parametrize("stage", [1, 2])
def test_stage_step_state_matches_jax(stage_steps, stage):
    check_step_state(stage_steps[stage], stage)


def check_step_state(run: dict, stage: int) -> None:
    """The state after a stage's step (a run of `stage_steps`) against its
    reference, leaf by leaf; stage 2's frozen RPN bit for bit."""
    jbefore, jafter, _ = run["jax"]
    ref = run["ref"][1]
    mine, lr = run["after"], run["lr"]
    assert {k for k in mine if ":" in k} == {k for k in ref if ":" in k}
    assert set(mine) - {k for k in mine if ":" in k} == {k for k in ref if ":" not in k}
    for key in ref:
        if key.endswith((".mean", ".var")):
            scale = float(ref[key].abs().max())
            err = float((mine[key] - ref[key]).abs().max())
            assert err <= STAT_RTOL * scale, (key, err)
    names = [k[3:] for k in ref if k.startswith("mu:")]
    # the first step's (clipped) gradient, from Adam's first moment
    grads = {n: ref[f"mu:{n}"] / (1 - 0.9) for n in names}
    top = max(float(g.abs().max()) for g in grads.values())
    checked = 0
    for name, g in grads.items():
        g_max = float(g.abs().max())
        if g_max <= ROUNDING_LEVEL * top:
            # at rounding level on both sides (a Dense bias that a BatchNorm
            # follows, a BatchNorm whose channels the next ReLU mostly cuts)
            mine_max = float(mine[f"mu:{name}"].abs().max()) / (1 - 0.9)
            assert mine_max <= ROUNDING_LEVEL * top, (name, mine_max / top)
            continue
        for moment in ("mu", "nu"):
            key = f"{moment}:{name}"
            assert (mine[key] - ref[key]).norm() <= MOMENT_RTOL * ref[key].norm(), key
        resolved = g.abs() > RESOLVED * g_max
        err = float((mine[name] - ref[name])[resolved].abs().max())
        assert err <= PARAM_TOL * lr, (name, err / lr)
        checked += 1
    assert checked > 10
    # a parameter outside the optimizer (stage 2: every rpn_* one) stays
    # bit for bit, as optax's set_to_zero keeps JAX's
    frozen = [k for k in run["before"] if k.startswith("rpn")
              and not k.endswith((".mean", ".var"))]
    if stage == 2:
        assert frozen and not any(f"mu:{k}" in mine for k in frozen)
        for key in frozen:
            assert torch.equal(mine[key], run["before"][key]), key
            assert torch.equal(jafter[key], jbefore[key]), key
    # the RPN ran in train mode on both sides: every one of its statistics moved
    means = [k for k in run["before"] if k.startswith("rpn") and k.endswith(".mean")]
    assert means and all(not torch.equal(mine[k], run["before"][k]) for k in means)
