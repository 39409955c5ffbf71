"""Parity of the PyTorch port's layers and flagship 3DSSD slice with the JAX
package, on shared weights converted from the flax variable tree.

Weights and inputs are made with numpy from a seed. BatchNorm statistics are
drawn away from their init values so that the converter and the eval-mode
BatchNorm are both exercised. The JAX side runs on the CPU, jitted.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from ssd3d.models import build_detector as jax_build_detector
from ssd3d.models.backbone import PointBackbone as JaxPointBackbone
from ssd3d.nn import layers as jlayers
from ssd3d_torch.entry import flagship
from ssd3d_torch.models.single_stage import build_detector
from ssd3d_torch.nn.layers import PointConv, SharedMLP
from ssd3d_torch.utils.convert import flax_to_state_dict

# f32: the port's CPU matmuls and XLA's dot sum in different orders; over the
# slice's ~20 layers that moves outputs by ~1e-6 relative (2e-6 measured on
# boxes of magnitude ~30).
F32_RTOL, F32_ATOL = 1e-4, 1e-4
# bf16: both frameworks round x, kernel, the product and the bias to bf16
# (8 significand bits) but accumulate in different orders, so a value may
# land one bf16 step (2^-8 relative) apart, and later layers carry that on.
BF16_LAYER_TOL = 2.0 ** -6  # relative to the largest output magnitude


def _t(a):
    return torch.from_numpy(np.array(a))


def _fill(shapes, seed):
    """Seeded values for a flax variable tree of ShapeDtypeStructs, chosen by
    leaf name: xavier-like kernels, small biases, BN statistics off init."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            lim = np.sqrt(6.0 / (s.shape[0] + s.shape[1]))
            return rng.uniform(-lim, lim, s.shape)
        if name == "scale":
            return rng.uniform(0.8, 1.2, s.shape)
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape)
        return rng.uniform(-0.1, 0.1, s.shape)  # bias, mean

    return jax.tree_util.tree_map_with_path(
        lambda p, s: leaf(p, s).astype(np.float32), shapes)


def _jax_variables(module, x, seed):
    shapes = jax.eval_shape(lambda v: module.init(jax.random.PRNGKey(0), v, False), x)
    return _fill(shapes, seed)


# ------------------------------------------------------------------ layers

@pytest.mark.parametrize("dtype,tol", [("float32", None), ("bfloat16", BF16_LAYER_TOL)])
def test_shared_mlp_and_point_conv_match_flax(dtype, tol):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    tdt = torch.bfloat16 if dtype == "bfloat16" else None
    x = np.random.RandomState(0).randn(2, 64, 16, 35).astype(np.float32)
    for jmod, tmod in [
        (jlayers.SharedMLP((32, 48, 64), compute_dtype=jdt),
         SharedMLP(35, (32, 48, 64), compute_dtype=tdt)),
        (jlayers.PointConv(24, compute_dtype=jdt), PointConv(35, 24, compute_dtype=tdt)),
        (jlayers.PointConv(7, bn=False, activation=False),
         PointConv(35, 7, bn=False, activation=False)),
    ]:
        variables = _jax_variables(jmod, jnp.asarray(x), 1)
        want = np.asarray(jmod.apply(variables, jnp.asarray(x), False), np.float32)
        tmod.load_state_dict(flax_to_state_dict(variables), strict=True)
        with torch.inference_mode():
            got = tmod.eval()(_t(x)).float().numpy()
        assert got.shape == want.shape
        if tol is None:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_batchnorm_runs_from_running_statistics():
    conv = PointConv(3, 2, activation=False).eval()
    with torch.no_grad():
        conv.conv.kernel.copy_(torch.eye(3)[:, :2])
        conv.conv.bias.zero_()
        conv.bn.mean.copy_(torch.tensor([1.0, -1.0]))
        conv.bn.var.copy_(torch.tensor([3.999, 0.999]))
        conv.bn.scale.copy_(torch.tensor([2.0, 1.0]))
        conv.bn.bias.copy_(torch.tensor([0.5, 0.0]))
    with torch.inference_mode():
        y = conv(torch.tensor([[5.0, 1.0, 9.0]]))
    # (x - mean) / sqrt(var + 1e-3) * scale + bias
    torch.testing.assert_close(y, torch.tensor([[4.5, 2.0]]))


def test_training_mode_runs_forward_and_backward():
    """flagship(...).train(), a forward and loss.backward() on the CPU: every
    parameter gets a finite gradient and every BatchNorm moves its running
    statistics by the momentum."""
    from ssd3d_torch.ops import _build

    model = flagship(shrink=8, device="cpu")[1].train()
    before = {k: v.clone() for k, v in model.named_buffers() if k.endswith((".mean", ".var"))}
    pts = torch.from_numpy((np.random.RandomState(4).randn(2, 2048, 4) * 10).astype(np.float32))
    _build.reset_launches()
    out = model(pts, 0.5)
    (out["cls"].float().square().mean() + out["offset"].square().mean()
     + out["vote_offset"][0].square().mean()).backward()
    assert set(_build.launches().values()) == {0}
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
    assert model.backbone.layer2.mlp0.conv0.conv.kernel.grad.abs().max() > 0
    for name, value in model.named_buffers():
        if name in before:
            assert not torch.equal(value, before[name]), name


def test_unported_layer_types_raise():
    cfg = flagship(shrink=8, device="cpu")[0]
    row = list(cfg.MODEL.NETWORK.FIRST_STAGE.ARCHITECTURE[0])
    row[10] = True  # attention grouping (FP and global SA layers are ported)
    cfg.MODEL.NETWORK.FIRST_STAGE.ARCHITECTURE = [row]
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        build_detector(cfg, device="cpu")


# -------------------------------------------------------- decode and NMS

def test_decode_and_nms_matches_jax():
    cfg = flagship(shrink=8, device="cpu")[0]
    _, jspec = jax_build_detector(cfg)
    _, tspec = build_detector(cfg, device="cpu")
    rng = np.random.RandomState(2)
    b, n = 2, 256
    outputs = {
        "base_xyz": rng.uniform(-20, 20, (b, n, 3)).astype(np.float32),
        "cls": rng.randn(b, n, 1).astype(np.float32),
        "offset": (rng.randn(b, n, 1, 6) * [1, 1, 1, 1.5, 0.7, 0.7]).astype(np.float32),
        "angle_cls": rng.randn(b, n, 1, 12).astype(np.float32),
        "angle_res": (rng.rand(b, n, 1, 12) - 0.5).astype(np.float32),
    }
    want = jspec.decode_and_nms({k: jnp.asarray(v) for k, v in outputs.items()})
    got = tspec.decode_and_nms({k: _t(v) for k, v in outputs.items()})
    assert set(got) == set(want)
    for key in ("classes", "valid", "index"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    for key in ("boxes", "scores"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    assert 0 < int(got["valid"].sum()) <= 2 * 100


# ------------------------------------------------------- the flagship slice

@pytest.fixture(scope="module")
def shrunk_flagship():
    """The flagship config at shrink 8 (2,048 points, full widths), seeded
    flax variables, and two scans."""
    cfg, jmodel, _, n = __graft_entry__._flagship(shrink=8)
    pts = (np.random.RandomState(0).randn(2, n, 4) * 10).astype(np.float32)
    variables = _jax_variables(jmodel, jnp.asarray(pts[:1]), 3)
    return cfg, variables, pts


def _run_both(cfg, variables, pts, dtype):
    """(JAX outputs, detections, backbone lists), (the port's)."""
    cfg.TPU.COMPUTE_DTYPE = dtype
    jmodel, jspec = jax_build_detector(cfg)

    def fwd(v, p):
        out, state = jmodel.apply(
            v, p, False, mutable=["intermediates"],
            capture_intermediates=lambda mdl, _: isinstance(mdl, JaxPointBackbone))
        net = state["intermediates"]["backbone"]["__call__"][0]
        return out, jspec.decode_and_nms(out), {k: net[k] for k in ("fps_idx", "features")}

    jax_side = jax.jit(fwd)(variables, jnp.asarray(pts))
    _, tmodel, tspec, _ = flagship(shrink=8, compute_dtype=dtype, device="cpu")
    tmodel.load_state_dict(flax_to_state_dict(variables), strict=True)
    with torch.inference_mode():
        out_t = tmodel(_t(pts))
        det_t = tspec.decode_and_nms(out_t)
        net_t = tmodel.backbone(_t(pts))
    return jax_side, (out_t, det_t, net_t), tmodel


def test_converter_loads_every_flagship_leaf(shrunk_flagship):
    _, variables, _ = shrunk_flagship
    sd = flax_to_state_dict(variables)
    assert len(jax.tree_util.tree_leaves(variables)) == len(sd) == 252
    model = flagship(shrink=8, device="cpu")[1]
    assert set(model.state_dict()) == set(sd)
    model.load_state_dict(sd, strict=True)
    kernel = "backbone.layer1.mlp0.conv0.conv.kernel"
    np.testing.assert_array_equal(
        model.state_dict()[kernel].numpy(),
        variables["params"]["backbone"]["layer1"]["mlp0"]["conv0"]["conv"]["kernel"])
    assert "backbone.vote_4.vote_offsets.conv.kernel" in sd  # scope dedupe


def test_flagship_slice_matches_jax_f32(shrunk_flagship):
    cfg, variables, pts = shrunk_flagship
    (out_j, det_j, net_j), (out_t, det_t, _), _ = _run_both(cfg, variables, pts, "float32")
    for layer, (fj, ft) in enumerate(zip(net_j["fps_idx"], out_t["fps_idx"])):
        assert (fj is None) == (ft is None), layer
        if fj is not None:
            np.testing.assert_array_equal(ft.numpy(), np.asarray(fj), err_msg=f"layer {layer}")
    for key in ("base_xyz", "cls", "offset", "angle_cls", "angle_res"):
        np.testing.assert_allclose(out_t[key].numpy(), np.asarray(out_j[key]),
                                   rtol=F32_RTOL, atol=F32_ATOL, err_msg=key)
    for key in ("classes", "valid", "index"):
        np.testing.assert_array_equal(det_t[key].numpy(), np.asarray(det_j[key]), err_msg=key)
    for key in ("boxes", "scores"):
        np.testing.assert_allclose(det_t[key].numpy(), np.asarray(det_j[key]),
                                   rtol=F32_RTOL, atol=F32_ATOL, err_msg=key)
    assert int(det_t["valid"].sum()) > 0


def test_flagship_slice_matches_jax_bf16(shrunk_flagship, record_property):
    """At the shipped bf16 the two frameworks' features differ by about one
    bf16 step, so the F-FPS picks of SA2 and SA3 may part where two
    candidates' distances lie within that step of each other; from there the
    clouds differ and outputs are not comparable point by point. On this
    input SA2 swaps two neighbouring picks. What must hold is what does not
    depend on that rounding."""
    cfg, variables, pts = shrunk_flagship
    (out_j, det_j, net_j), (out_t, det_t, net_t), tmodel = _run_both(
        cfg, variables, pts, "bfloat16")
    # SA1 samples raw xyz: picks equal; its features agree to bf16 rounding
    np.testing.assert_array_equal(net_t["fps_idx"][1].numpy(), np.asarray(net_j["fps_idx"][1]))
    want = np.asarray(net_j["features"][1], np.float32)
    assert np.abs(net_t["features"][1].numpy() - want).max() <= BF16_LAYER_TOL * np.abs(want).max()
    # every F-FPS pick of the port is a farthest point of its own inputs
    from ssd3d_torch.nn.modules import ffps_segments
    from ssd3d_torch.ops.sampling import fps_pick_shortfall

    arch = cfg.MODEL.NETWORK.FIRST_STAGE.ARCHITECTURE
    checked = 0
    for layer, row in enumerate(arch, start=1):
        if row[11] != "SA_Layer" or row[14] != -1:
            continue
        src = row[0][0]
        for fused, picks in ffps_segments(net_t["xyz"][src], net_t["features"][src],
                                          net_t["fps_idx"][layer], row[6], row[7], row[8]):
            assert fps_pick_shortfall(fused, picks) <= 1e-5
            checked += 1
    assert checked == 2  # SA2's FS segment and SA3's F-FPS segment
    same = all(np.array_equal(ft.numpy(), np.asarray(fj))
               for fj, ft in zip(net_j["fps_idx"], net_t["fps_idx"]) if fj is not None)
    record_property("bf16_picks_equal", same)
    if same:
        for key in ("cls", "offset", "angle_cls", "angle_res"):
            want = np.asarray(out_j[key], np.float32)
            err = np.abs(out_t[key].float().numpy() - want).max()
            assert err <= BF16_LAYER_TOL * np.abs(want).max(), (key, err)
    # the slice still ends in at most 100 finite boxes per scan
    assert torch.isfinite(det_t["boxes"]).all()
    assert (det_t["valid"].sum(-1) <= 100).all() and det_t["valid"].any()
