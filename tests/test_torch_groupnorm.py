"""GroupNorm (MODEL.NETWORK.USE_GN) in the PyTorch port against the JAX
package on the CPU: the layer against `flax.linen.GroupNorm` at each input
shape it meets (its output and gradients), the converter carrying
`gn/scale` and `gn/bias`, K7's gate refusing GroupNorm, and two models with
USE_GN on: the shrunk flagship (forward, then one train step's losses,
gradient leaves and BatchNorm-free state) and the tiny PointRCNN (two-stage
inference, where the RCNN's GroupNorm reduces over each RoI, then one
stage-1 step).

Inputs and weights are made with numpy from seeds; the weights reach the
port through `flax_to_state_dict`. The JAX side runs on the CPU, jitted.
"""

from __future__ import annotations

from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from ssd3d.config import load_cfg as jax_load_cfg
from ssd3d.models import build_detector as jax_build_detector
from ssd3d.models.api import build_pipeline as jax_build_pipeline
from ssd3d.nn import layers as jlayers
from ssd3d.train.train_step import TrainGraph as JaxTrainGraph
from ssd3d_torch.entry import synthetic_scenes
from ssd3d_torch.models.api import build_pipeline
from ssd3d_torch.models.single_stage import build_detector
from ssd3d_torch.nn.layers import GroupNorm, PointConv
from ssd3d_torch.nn.modules import PointnetSAModuleMSG
from ssd3d_torch.ops import _build
from ssd3d_torch.train import schedules
from ssd3d_torch.train.train_step import TrainGraph
from ssd3d_torch.utils.convert import flax_to_state_dict

import test_torch_two_stage_train as ttwo

REPO = Path(__file__).resolve().parents[1]
TINY = str(REPO / "configs/kitti/pointrcnn/pointrcnn_tiny_stage{}.yaml")
# the layer: output and gradients within this share of the largest |value|
# (f32 reductions over up to ~16,000 values in another order than XLA's)
GN_TOL = 1e-5
# whole models at f32: outputs relative to their largest |value|
F32_TOL = 1e-4
# one train step, held to the JAX step run in float64 from the same state
# (the f32 step is ill-conditioned: JAX's own f32 gradients lie up to ~8% of
# a leaf's norm from its float64 run on the GroupNorm flagship, recorded):
# each loss relative to itself; gradient leaves as ||g_port - g_64|| /
# ||g_64||, the bound tests/test_torch_train.py's FLAGSHIP_GRAD_TOL states
LOSS_RTOL = 1e-4
GRAD_TOL = 5e-2
PRE_TOPK = 512


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close_rel(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= rtol * max(np.abs(want).max(), 1e-30), (what, err, np.abs(want).max())


def _fill(shapes, seed):
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            lim = np.sqrt(6.0 / (s.shape[0] + s.shape[1]))
            if any(getattr(p, "key", None) == "vote_offsets" for p in path):
                lim *= 0.1
            return rng.uniform(-lim, lim, s.shape)
        if name in ("scale", "var"):
            return rng.uniform(0.8, 1.2, s.shape)
        return rng.uniform(-0.1, 0.1, s.shape)

    return jax.tree_util.tree_map_with_path(lambda p, s: leaf(p, s).astype(np.float32), shapes)


# ---------------------------------------------------------------- the layer

@pytest.mark.parametrize("shape", [
    (2, 32, 16, 64),  # an SA layer's grouped input: [scan, centres, samples, c]
    (2, 64, 96),  # aggregation, vote layer, heads: [scan, points, c]
    (2, 256, 32),  # a decoder (FP) layer
    (16, 8, 16, 16),  # the RCNN's grouped input: [RoI, centres, samples, c]
    (16, 32, 64),  # the RCNN's global pooling MLP: [RoI, points, c]
    (3, 20),  # [batch, c]: the statistics of each row's groups alone
])
def test_groupnorm_matches_flax(shape):
    c = shape[-1]
    rng = np.random.RandomState(c + len(shape))
    x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
    w = rng.randn(*shape).astype(np.float32)  # weights the output for a gradient
    params = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "bias": rng.uniform(-0.2, 0.2, c).astype(np.float32)}
    jgn = fnn.GroupNorm(num_groups=min(32, c))

    def f(p, xx):
        out = jgn.apply({"params": p}, xx)
        return jnp.sum(out * w), out

    (_, want), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    gn = GroupNorm(c)
    assert gn.groups == min(32, c) and gn.epsilon == 1e-6
    gn.load_state_dict({k: _t(v) for k, v in params.items()}, strict=True)
    xt = _t(x).requires_grad_(True)
    got = gn(xt)
    (got * _t(w)).sum().backward()
    assert got.dtype == torch.float32
    _close_rel(got.detach().numpy(), want, GN_TOL, "output")
    _close_rel(xt.grad.numpy(), gx, GN_TOL, "dx")
    for k in ("scale", "bias"):
        _close_rel(getattr(gn, k).grad.numpy(), gp[k], GN_TOL, f"d{k}")


def test_groupnorm_refuses_channels_its_groups_do_not_divide():
    x = jnp.zeros((2, 5, 48))
    with pytest.raises(ValueError, match="does not divide"):
        fnn.GroupNorm(num_groups=32).init(jax.random.PRNGKey(0), x)
    with pytest.raises(ValueError, match="do not divide"):
        GroupNorm(48)


def test_groupnorm_takes_bf16_input_to_f32_as_flax():
    x = np.random.RandomState(1).randn(2, 10, 64).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    jgn = fnn.GroupNorm(num_groups=32)
    want = jgn.apply(jgn.init(jax.random.PRNGKey(0), xb), xb)
    got = GroupNorm(64)(torch.from_numpy(np.asarray(xb.astype(jnp.float32))).bfloat16())
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    _close_rel(got.detach().numpy(), want, GN_TOL, "bf16 input")


def test_converter_carries_gn_scale_and_bias():
    x = jnp.asarray(np.random.RandomState(2).randn(2, 40, 35).astype(np.float32))
    jconv = jlayers.PointConv(64, use_gn=True)
    shapes = jax.eval_shape(lambda v: jconv.init(jax.random.PRNGKey(0), v, False), x)
    variables = _fill(shapes, 3)
    sd = flax_to_state_dict(variables)
    assert set(sd) == {"conv.kernel", "conv.bias", "gn.scale", "gn.bias"}
    conv = PointConv(35, 64, use_gn=True)
    assert conv.bn is None and isinstance(conv.gn, GroupNorm)
    conv.load_state_dict(sd, strict=True)
    want = jconv.apply(variables, x, True)
    with torch.no_grad():
        got = conv.train()(_t(x))
    _close_rel(got.numpy(), want, GN_TOL, "PointConv with GroupNorm")


def test_k7_gate_and_fold_refuse_groupnorm():
    """The fused route (K7) folds BatchNorm into an affine; GroupNorm
    normalises by its input and never takes it."""
    args = dict(radius_list=[0.4], nsample_list=[16], mlp_list=[[16, 32]], bn=True,
                fps_sample_range_list=[-1], fps_method_list=["D-FPS"], npoint_list=[32],
                dilated_group=False, aggregation_channel=None)
    packed = torch.zeros(64, 128, 16 + 3)  # the RoI regime: 64 clouds of 128 points
    queries = [(torch.zeros(64, 32, 16, dtype=torch.int32), torch.ones(64, 32))]
    bn_layer = PointnetSAModuleMSG(16, **args).eval()
    gn_layer = PointnetSAModuleMSG(16, use_gn=True, **args).eval()
    assert bn_layer._use_fused(packed, queries)
    assert not gn_layer._use_fused(packed, queries)
    with pytest.raises(ValueError, match="GroupNorm"):
        gn_layer.mlp0.fold()


# ---------------------------------------------- the flagship with USE_GN

@pytest.fixture(scope="module")
def gn_flagship():
    cfg, _, _, n = __graft_entry__._flagship(shrink=16)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.MODEL.NETWORK.USE_GN = True
    jmodel, jspec = jax_build_detector(cfg)
    data = synthetic_scenes(2, n, 31)
    rng = np.random.RandomState(31)
    for b in range(2):  # a third of each scan inside its cars: positives
        boxes = data["gt_boxes"][b][data["gt_labels"][b] > 0]
        k = n // 3
        box = boxes[rng.randint(0, len(boxes), k)]
        local = rng.uniform(-0.5, 0.5, (k, 3)) * box[:, [3, 4, 5]]
        local[:, 1] -= box[:, 4] / 2.0
        c, s = np.cos(box[:, 6]), np.sin(box[:, 6])
        data["points"][b, :k, :3] = (np.stack([c * local[:, 0] + s * local[:, 2], local[:, 1],
                                               -s * local[:, 0] + c * local[:, 2]], -1)
                                     + box[:, :3]).astype(np.float32)
    shapes = jax.eval_shape(lambda p: jmodel.init(jax.random.PRNGKey(0), p, False),
                            jnp.asarray(data["points"][:1]))
    variables = _fill(shapes, 32)
    model, spec = build_detector(cfg, device="cpu")
    sd = flax_to_state_dict(variables)
    assert any(k.endswith("gn.scale") for k in sd) and not any(".bn." in k for k in sd)
    model.load_state_dict(sd, strict=True)
    return cfg, jmodel, jspec, variables, model, spec, data


def test_groupnorm_flagship_forward_matches_jax(gn_flagship):
    _, jmodel, _, variables, model, _, data = gn_flagship
    want = jax.jit(lambda v, p: jmodel.apply(v, p, False))(variables, jnp.asarray(data["points"]))
    with torch.inference_mode():
        got = model.eval()(_t(data["points"]))
    np.testing.assert_array_equal(got["vote_base"][0].numpy(), np.asarray(want["vote_base"][0]))
    for key in ("base_xyz", "cls", "offset", "angle_cls", "angle_res"):
        _close_rel(got[key].numpy(), want[key], F32_TOL, key)


def _step_against_float64(graph, jgraph, variables, data, bn_m, record_property,
                          only_prefix="", jax_f32=False):
    """One f32 loss and gradient of the port (`graph`, on a model holding
    `variables`) against the JAX step in float64 from the same state on the
    same batch; with `jax_f32` also records how far JAX's own f32
    gradients lie from it."""
    args = ({k: jnp.asarray(v) for k, v in data.items()}, jax.random.PRNGKey(1), bn_m)
    if jax_f32:
        _, grads32 = jax.jit(jax.value_and_grad(jgraph.compute_losses, has_aux=True))(
            variables["params"], variables.get("batch_stats", {}), *args)
        jax32 = flax_to_state_dict({"params": _np(grads32)})
    with ttwo._float64():
        v64 = ttwo._to64(variables)
        (total, (losses, _)), grads = jax.jit(jax.value_and_grad(jgraph.compute_losses,
                                                                 has_aux=True))(
            v64["params"], v64.get("batch_stats", {}), ttwo._to64(args[0]), *args[1:])
        want_losses = {k: float(v) for k, v in losses.items()}
        total = float(total)
        want_g = {k: v.double() for k, v in flax_to_state_dict({"params": _np(grads)}).items()}
    model = graph.model
    model.train()
    model.zero_grad(set_to_none=True)
    got_total, got_losses = graph.compute_losses({k: _t(v) for k, v in data.items()}, bn_m)
    got_total.backward()
    assert set(got_losses) == set(want_losses)
    for key, value in got_losses.items():
        assert float(value.detach()) > 0, key  # every loss live
        _close_rel(float(value.detach()), want_losses[key], LOSS_RTOL, key)
    _close_rel(float(got_total.detach()), total, LOSS_RTOL, "total")
    worst = {"port": 0.0, "jax": 0.0}
    named = dict(model.named_parameters())
    for name, p in named.items():
        if not name.startswith(only_prefix):
            continue
        ref = want_g[name].norm().clamp(min=1e-30)
        if name.endswith("conv.bias") and name[:-9] + "gn.scale" in named and p.numel() <= 32:
            # a Dense bias before a GroupNorm of one channel a group has an
            # exact gradient of 0 (the group's mean takes it out): held
            # against the norm of the same layer's kernel gradient
            ref = want_g[name[:-4] + "kernel"].norm()
        err = float((p.grad.double() - want_g[name]).norm() / ref)
        assert err <= GRAD_TOL, (name, err)
        worst["port"] = max(worst["port"], err)
        if jax_f32:
            worst["jax"] = max(worst["jax"],
                               float((jax32[name].double() - want_g[name]).norm() / ref))
    for side, err in worst.items():
        if side == "port" or jax_f32:
            record_property(f"{side}_f32_grad_from_float64", err)
    return named


def test_groupnorm_flagship_train_step_matches_jax(gn_flagship, record_property):
    cfg, jmodel, jspec, variables, model, spec, data = gn_flagship
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    named = _step_against_float64(TrainGraph.build(cfg, model, spec),
                                  JaxTrainGraph.build(cfg, jmodel, jspec), variables, data,
                                  float(schedules.bn_momentum(cfg.SOLVER, 0)), record_property,
                                  jax_f32=True)
    assert named["backbone.layer1.mlp0.conv0.gn.scale"].grad.abs().max() > 0


# --------------------------------------- the tiny PointRCNN with USE_GN

def _scans(rng, bs=2, n=2048):
    """Uniform clutter with two dense car-sized clusters a scan."""
    pts = (rng.uniform(-1, 1, (bs, n, 4)) * np.array([15, 1.5, 10, 1])).astype(np.float32)
    pts[..., 2] += 14
    for g, (x, z) in enumerate([(2.0, 10.0), (-6.0, 18.0)]):
        sel = slice(g * 300, (g + 1) * 300)
        pts[:, sel, 0] = x + rng.uniform(-1.5, 1.5, (bs, 300))
        pts[:, sel, 1] = 1.5 - rng.uniform(0, 1.5, (bs, 300))
        pts[:, sel, 2] = z + rng.uniform(-0.7, 0.7, (bs, 300))
    return pts


def _gn_pipelines(stage: int):
    opts = ["TPU.COMPUTE_DTYPE", "float32", "MODEL.NETWORK.USE_GN", "True",
            "MODEL.FIRST_STAGE.MAX_OUTPUT_NUM", "16"]
    jcfg = jax_load_cfg(TINY.format(stage), opts)
    jpipe = jax_build_pipeline(jcfg, nms_pre_topk=PRE_TOPK)
    points = _scans(np.random.RandomState(stage))
    shapes = jax.eval_shape(lambda p: jpipe.model.init(jax.random.PRNGKey(0), p, False, 0.9,
                                                       rpn_spec=jpipe.graph.rpn_spec),
                            jnp.asarray(points[:1]))
    variables = _fill(shapes, 40 + stage)
    pipe = build_pipeline(jcfg, nms_pre_topk=PRE_TOPK, device="cpu")
    pipe.model.load_state_dict(flax_to_state_dict(variables), strict=True)
    return jcfg, jpipe, variables, pipe, points


def test_groupnorm_pointrcnn_inference_matches_jax(record_property):
    """RPN, proposals, RegionPool (GroupNorm over each scan's RoIs), the
    RCNN (GroupNorm over each RoI cloud, unfused) and NMS, held to the JAX
    pipeline run in float64 from the same weights: GroupNorm's epsilon of
    1e-6 over a RoI's few distinct points magnifies f32 rounding, and the
    JAX package's own f32 run lay 1.008 m (a flipped x bin) from its
    float64 run on these scans when this test was written, where the
    port's lies within 1e-4 of the largest value (recorded)."""
    _, jpipe, variables, pipe, points = _gn_pipelines(2)
    assert pipe.model.use_gn and pipe.model.roi_pool.align.conv0.gn is not None
    with ttwo._float64():
        want = {k: np.asarray(v) for k, v in jax.jit(jpipe.infer)(
            ttwo._to64(variables), jnp.asarray(points, jnp.float64)).items()}
    _build.reset_launches()
    got = {k: v.numpy() for k, v in pipe.infer(_t(points)).items()}
    assert set(_build.launches().values()) == {0}
    assert set(got) == set(want)
    for key in ("proposals_valid", "valid", "classes", "index"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert want["proposals_valid"].any() and want["valid"].any()
    _close_rel(got["proposals"], want["proposals"], F32_TOL, "proposals")
    valid = want["valid"]
    for key in ("boxes", "scores"):
        _close_rel(got[key][valid], want[key][valid], F32_TOL, key)
    record_property("port_f32_boxes_from_float64",
                    float(np.abs(got["boxes"][valid] - want["boxes"][valid]).max()))


def test_groupnorm_pointrcnn_stage1_step_matches_jax(record_property):
    jcfg, jpipe, variables, pipe, _ = _gn_pipelines(1)
    data = synthetic_scenes(2, 2048, seed=7)
    pipe.graph.init_state()
    _step_against_float64(pipe.graph, jpipe.graph, variables, data,
                          float(schedules.bn_momentum(jcfg.SOLVER, 0)), record_property,
                          only_prefix="rpn")  # stage 1 trains the RPN
