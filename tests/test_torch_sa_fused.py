"""The fused set abstraction, the FP layer and global SSG pooling: the port
against the JAX package.

Inputs and weights are made with numpy from a seed. The JAX side runs
`sa_fused_multi` / `sa_fused_pallas` in interpret mode with f32 dots (the
two-stage configs' mode), as the JAX package's own kernel tests run them, and
its flax modules on their CPU route. The port runs its plain versions, what
a CPU tensor dispatches to. Tests marked `cuda` hold kernel K7 to its plain
version and skip without a GPU. The flax modules are imported inside the
tests that use them, so that the `cuda` tests also run where only jax is
installed.
"""

from __future__ import annotations

import functools
import importlib
import re
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas

from ssd3d_torch.nn import modules
from ssd3d_torch.nn.layers import SharedMLP
from ssd3d_torch.ops import _build, sa_fused
from ssd3d_torch.ops.grouping import gather_rows_plain
from ssd3d_torch.utils.convert import flax_to_state_dict

# f32 throughout: the two sides sum each dot in another order (XLA's CPU dot
# or the CPU BLAS), about 1e-7 relative per layer; held within 1e-5 of the
# output's largest |value|. The `cuda` tests hold K7 (3xTF32 on its wgmma
# route, fmaf on its FMA route) to its plain version within 1e-4.
F32_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=F32_TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, (err, scale)


def _fill(shapes, seed):
    """Seeded values for a flax variable tree: xavier-like kernels, small
    biases, BatchNorm statistics away from their init values."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            lim = np.sqrt(6.0 / (s.shape[0] + s.shape[1]))
            return rng.uniform(-lim, lim, s.shape)
        if name in ("scale", "var"):
            return rng.uniform(0.6, 1.4, s.shape)
        return rng.uniform(-0.1, 0.1, s.shape)

    return jax.tree_util.tree_map_with_path(lambda p, s: leaf(p, s).astype(np.float32), shapes)


def _layers(rng, c, widths):
    """Folded layers (kernel, bias, inv, shift) as numpy arrays."""
    out = []
    for ch in widths:
        out.append((rng.randn(c, ch).astype(np.float32) * 0.3,
                    rng.randn(ch).astype(np.float32) * 0.1,
                    np.abs(rng.randn(ch)).astype(np.float32),
                    rng.randn(ch).astype(np.float32) * 0.1))
        c = ch
    return out


@pytest.fixture(scope="module")
def jax_sa_fused():
    """The JAX package's fused-SA module with its pallas_call in interpret
    mode (reloaded, so no compiled TPU executable is reused)."""
    orig = pallas.pallas_call
    with mock.patch.object(pallas, "pallas_call", functools.partial(orig, interpret=True)):
        import ssd3d.ops.pallas.sa_fused as sf

        yield importlib.reload(sf)


def _inputs(seed, b, n, cf, m, ns_list):
    rng = np.random.RandomState(seed)
    src = rng.randn(b, n, cf + 3).astype(np.float32)
    idx = [rng.randint(0, n, (b, m, ns)).astype(np.int32) for ns in ns_list]
    centers = rng.randn(b, m, 3).astype(np.float32)
    masks = (rng.rand(b, m, len(ns_list)) > 0.2).astype(np.float32)
    return rng, src, idx, centers, masks


@pytest.mark.parametrize("aggregate", [False, True])
def test_sa_fused_multi_plain_matches_jax(jax_sa_fused, aggregate):
    """Two scales (ns 16 and 32, different depths), masked, with and
    without the aggregation layer."""
    rng, src, idx, centers, masks = _inputs(1, 2, 256, 13, 64, [16, 32])
    layers = [_layers(rng, 16, (16, 24)), _layers(rng, 16, (16, 16, 32))]
    agg = _layers(rng, 24 + 32, (40,))[0] if aggregate else None
    want = jax_sa_fused.sa_fused_multi(
        jnp.asarray(src), [jnp.asarray(i) for i in idx], jnp.asarray(centers),
        jnp.asarray(masks), [[tuple(map(jnp.asarray, lay)) for lay in ls] for ls in layers],
        tuple(map(jnp.asarray, agg)) if agg else None, dots_bf16=False)
    got = sa_fused.sa_fused_multi(
        _t(src), [_t(i) for i in idx], _t(centers), _t(masks),
        [[tuple(map(_t, lay)) for lay in ls] for ls in layers],
        tuple(map(_t, agg)) if agg else None)
    assert got.shape == (2, 64, 40 if aggregate else 56)
    _close(got.numpy(), want)
    if not aggregate:  # an empty ball's scale is zero before any aggregation
        assert (got.numpy()[..., :24][masks[..., 0] == 0] == 0).all()


def test_sa_fused_single_scale_matches_jax(jax_sa_fused):
    rng, src, (idx,), centers, _ = _inputs(2, 2, 512, 5, 64, [16])
    layers = _layers(rng, 8, (16, 32))
    want = jax_sa_fused.sa_fused_pallas(jnp.asarray(src), jnp.asarray(idx), jnp.asarray(centers),
                                        [tuple(map(jnp.asarray, lay)) for lay in layers],
                                        dots_bf16=False)
    got = sa_fused.sa_fused(_t(src), _t(idx), _t(centers), [tuple(map(_t, lay)) for lay in layers])
    _close(got.numpy(), want)


def _sa_tf32(src, idx_list, centers, masks, layers_list, terms):
    """The plain version with every scale layer's dot in TF32, as K7's wgmma
    route computes it: operands split into big = tf32_round(x) and small =
    tf32_round(x - big); terms 3 is big.big + big.small + small.big summed in
    f32, terms 1 one TF32 pass (big.big)."""
    cf = src.shape[-1] - 3
    feats = []
    for k, (idx, layers) in enumerate(zip(idx_list, layers_list)):
        b, m, ns = idx.shape
        g = gather_rows_plain(src, idx.reshape(b, m * ns)).reshape(b, m, ns, -1)
        x = torch.cat([g[..., :cf], g[..., cf:] - centers[:, :, None, :]], dim=-1)
        for w, bias, inv, shift in layers:
            xb, wb = sa_fused.tf32_round(x), sa_fused.tf32_round(w)
            dot = xb @ wb
            if terms == 3:
                dot = dot + xb @ sa_fused.tf32_round(w - wb) + sa_fused.tf32_round(x - xb) @ wb
            x = torch.relu((dot + bias) * inv + shift)
        feats.append(x.amax(2) * masks[..., k:k + 1])
    return torch.cat(feats, dim=-1)


def test_3xtf32_holds_k7_tolerance_at_rcnn_sa1_widths(jax_sa_fused, capsys):
    """K7's wgmma route in 3xTF32, emulated on the CPU at the RCNN SA1 widths
    (259 -> 128 -> 128 -> 128, ns 64) against the JAX package's f32 path:
    within K7_TOL = 1e-4 of the largest |value|, the tolerance chip_smoke.py
    holds the kernel to. One TF32 pass is logged, not asserted."""
    rng, src, idx, centers, masks = _inputs(14, 2, 512, 256, 16, [64])
    layers = [_layers(rng, 259, (128, 128, 128))]
    want = np.asarray(jax_sa_fused.sa_fused_multi(
        jnp.asarray(src), [jnp.asarray(i) for i in idx], jnp.asarray(centers),
        jnp.asarray(masks), [[tuple(map(jnp.asarray, lay)) for lay in ls] for ls in layers],
        None, dots_bf16=False))
    args = (_t(src), [_t(i) for i in idx], _t(centers), _t(masks),
            [[tuple(map(_t, lay)) for lay in ls] for ls in layers])
    scale = np.abs(want).max()
    errs = {terms: np.abs(_sa_tf32(*args, terms).numpy() - want).max() / scale
            for terms in (3, 1)}
    with capsys.disabled():
        print(f"\n3xTF32 {errs[3]:.3g}, one TF32 pass {errs[1]:.3g} of the largest |value| "
              f"(K7_TOL 1e-4)")
    assert errs[3] <= 1e-4, errs


def test_sa_fused_envelope():
    """ns must divide 128; one route's buffers must fit the H100's shared
    memory (the RCNN's SA1 and SA2 take the wgmma route); outside it both
    devices raise."""
    assert sa_fused.supports(259, [64], [[128, 128, 128]])  # RCNN SA1
    assert sa_fused.supports(131, [64], [[128, 128, 256]])  # RCNN SA2
    assert sa_fused.sa_fused_route(259, [64], [[128, 128, 128]]) == "wgmma"
    assert sa_fused.sa_fused_route(131, [64], [[128, 128, 256]]) == "wgmma"
    assert sa_fused.smem_bytes(259, [64], [[128, 128, 128]], "wgmma") <= 232448
    assert sa_fused.sa_fused_route(131, [64], [[300]]) == "fma"  # a layer past 256
    assert not sa_fused.supports(259, [48], [[128]])
    assert not sa_fused.supports(259, [64], [[512, 512]])
    assert not sa_fused.supports(16, [16] * 5, [[8]] * 5)
    rng, src, idx, centers, masks = _inputs(3, 1, 32, 5, 8, [12])
    with pytest.raises(ValueError, match="envelope"):
        sa_fused.sa_fused_multi(_t(src), [_t(i) for i in idx], _t(centers), _t(masks),
                                [[tuple(map(_t, lay)) for lay in _layers(rng, 8, (8,))]])


def test_envelope_numbers_come_from_the_kernels_header():
    """`supports`, `smem_bytes` and the weight staging use the numbers K7
    compiles with: the header's constants, which `sa_fused.cu` includes and
    does not redefine."""
    header = (_build.CSRC / "sa_fused.cuh").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", header)}
    assert consts == {"kRows": 128, "kCols": 128, "kKC": 16, "kMaxScales": 4, "kMaxLayers": 4,
                      "kMaxSmem": 232448, "kTcPasses": 2, "kTcStage": 4096, "kTcStages": 5}
    assert (sa_fused.ROWS, sa_fused.MAX_SCALES, sa_fused.MAX_LAYERS) == (128, 4, 4)
    assert (sa_fused.TC_PASSES, sa_fused.TC_STAGE, sa_fused.TC_STAGES) == (2, 4096, 5)
    source = (_build.CSRC / "sa_fused.cu").read_text()
    assert '#include "sa_fused.cuh"' in source
    assert not any(re.search(rf"\b{k}\s*=", source) for k in consts)
    # FMA, RCNN SA1: rows of 259 (odd already) and 128 -> 129 words, the
    # 16 x 128 weight chunk, 2 centres x 128 pooled channels
    assert sa_fused.smem_bytes(259, [64], [[128, 128, 128]]) == 4 * (128 * (259 + 129)
                                                                     + 16 * 128 + 2 * 128)
    # wgmma, RCNN SA1 and SA2: five 4096-float stages and their two
    # barriers each, a tile of stride 264 (259 -> 264 = 8 mod 32; SA2's
    # 256-wide layer also needs 264), 2 x 128 or 256 pooled
    assert sa_fused.smem_bytes(259, [64], [[128, 128, 128]], "wgmma") == 4 * (
        5 * 4096 + 128 * 264 + 2 * 128) + 5 * 16
    assert sa_fused.smem_bytes(131, [64], [[128, 128, 256]], "wgmma") == 4 * (
        5 * 4096 + 128 * 264 + 2 * 256) + 5 * 16
    # the wgmma route takes rows up to 264 wide (tile stride 264; 296 is past
    # the limit), the FMA route the wider ones while its buffers fit
    assert sa_fused.sa_fused_route(264, [64], [[128]]) == "wgmma"
    assert sa_fused.sa_fused_route(265, [64], [[128]]) == "fma"
    # supports() turns false at the first width whose buffers pass the limit
    # on both routes; every shape the FMA route fits is still taken
    edge = next(cp for cp in range(100, 600) if not sa_fused.supports(cp, [64], [[128]]))
    assert sa_fused.supports(edge - 1, [64], [[128]])
    assert min(sa_fused.smem_bytes(edge, [64], [[128]], r) for r in ("fma", "wgmma")) > consts[
        "kMaxSmem"]
    assert all(sa_fused.supports(w, [64], [[w]]) for w in range(3, 600)
               if sa_fused.smem_bytes(w, [64], [[w]]) <= consts["kMaxSmem"])
    assert sa_fused.supports(3, [1] * 4, [[4] * 4] * 4)
    assert not sa_fused.supports(3, [1] * 5, [[4]] * 5)
    assert not sa_fused.supports(3, [1], [[4] * 5])


def test_staged_weights_are_the_layout_the_descriptors_read():
    """`stage_weights` against a read of each wgmma operand the way K7's
    descriptors and A fragments address it: big + small of every staged
    weight is W in the fragment's channel order, zero in the padding."""
    rng = np.random.RandomState(15)
    for ci, co in [(259, 128), (128, 256), (13, 40)]:
        w = _t(rng.randn(ci, co).astype(np.float32))
        staged, ep = sa_fused.stage_weights((w, _t(rng.randn(co).astype(np.float32)),
                                             torch.ones(co), torch.zeros(co)))
        kp, np_ = -(-ci // 8) * 8, -(-co // 128)
        kc = sa_fused.TC_STAGE // (2 * np_ * 128)
        got = torch.zeros(kp, np_ * 128)
        for c, k0 in enumerate(range(0, kp, kc)):
            kcl = min(kc, kp - k0)
            stage = staged[c * sa_fused.TC_STAGE:]
            part = kcl // 4 * 512
            for kb in range(kcl // 8):
                for p in range(8):  # the A fragment's column p is channel 2p or 2(p - 4) + 1
                    chan = k0 + 8 * kb + (2 * p if p < 4 else 2 * (p - 4) + 1)
                    for j in range(np_):
                        n = torch.arange(128)
                        at = (j * part + (2 * kb + p // 4) * 512 + n // 8 * 32 + n % 8 * 4 + p % 4)
                        got[chan, j * 128 + n] = stage[at] + stage[at + np_ * part]
        assert torch.equal(sa_fused.tf32_round(got[:ci, :co]), sa_fused.tf32_round(w))
        assert (got[:ci, :co] - w).abs().max() <= 2.0 ** -20 * w.abs().max()
        assert (got[ci:] == 0).all() and (got[:, co:] == 0).all()
        assert ep.shape == (3 * np_ * 128,) and (ep.view(3, -1)[:, co:] == 0).all()


def test_fold_matches_jax_fold_and_the_eval_forward():
    from ssd3d.nn import layers as jlayers

    x = np.random.RandomState(4).randn(3, 10, 7).astype(np.float32)
    jmlp = jlayers.SharedMLP((12, 9))
    variables = _fill(jax.eval_shape(lambda v: jmlp.init(jax.random.PRNGKey(0), v, False),
                                     jnp.asarray(x)), 5)
    want = jmlp.apply(variables, jnp.asarray(x), False, fold=True)
    mlp = SharedMLP(7, (12, 9)).eval()
    mlp.load_state_dict(flax_to_state_dict(variables), strict=True)
    got = mlp.fold()
    for g, w in zip(got, want):
        for gt, wt in zip(g, w):
            np.testing.assert_allclose(gt.detach().numpy(), np.asarray(wt), rtol=1e-6, atol=1e-7)
    y = _t(x)
    for w, b, inv, shift in got:
        y = torch.relu((y @ w + b) * inv + shift)
    with torch.no_grad():
        _close(y.numpy(), mlp(_t(x)).numpy(), 1e-6)
    with pytest.raises(ValueError, match="eval mode"):
        mlp.train().fold()


# ------------------------------------------------ the modules, against flax

def _roi_clouds(seed, b, n, cf):
    rng = np.random.RandomState(seed)
    xyz = (rng.randn(b, n, 3) * 0.5).astype(np.float32)
    feats = rng.randn(b, n, cf).astype(np.float32)
    return xyz, feats


@pytest.mark.parametrize("agg", [None, 24])
def test_sa_module_in_the_roi_regime_takes_the_fused_route_and_matches_jax(agg):
    """b = 64 clouds of n = 128 points (the RCNN's regime): the port takes the
    fused op; the JAX module takes its unfused CPU route."""
    from ssd3d.nn import modules as jmodules

    xyz, feats = _roi_clouds(6, 64, 128, 13)
    kw = dict(radius_list=(0.4, 0.8), nsample_list=(16, 32), mlp_list=((16, 16), (16, 32)),
              bn=True, fps_sample_range_list=(-1,), fps_method_list=("D-FPS",),
              npoint_list=(32,), dilated_group=False, aggregation_channel=agg)
    jmod = jmodules.PointnetSAModuleMSG(use_attention=False, **kw)
    args = (jnp.asarray(xyz), jnp.asarray(feats), None, None, False)
    variables = _fill(jax.eval_shape(lambda a, f: jmod.init(jax.random.PRNGKey(0), a, f,
                                                            None, None, False), *args[:2]), 7)
    want_xyz, want_feat, want_idx = jax.jit(lambda v, a, f: jmod.apply(v, a, f, None, None, False)
                                            )(variables, *args[:2])
    tmod = modules.PointnetSAModuleMSG(13, **kw).eval()
    tmod.load_state_dict(flax_to_state_dict(variables), strict=True)
    with mock.patch.object(sa_fused, "sa_fused_multi", wraps=sa_fused.sa_fused_multi) as spy:
        with torch.inference_mode():
            got_xyz, got_feat, got_idx = tmod(_t(xyz), _t(feats))
            small = tmod(_t(xyz[:8]), _t(feats[:8]))[1]  # b = 8: the unfused route
    assert spy.call_count == 1
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
    _close(got_feat.numpy(), want_feat)
    _close(small.numpy(), got_feat.numpy()[:8])


def test_fp_module_matches_jax():
    from ssd3d.nn import modules as jmodules

    rng = np.random.RandomState(8)
    xyz1, xyz2 = (rng.randn(2, 300, 3) * 3).astype(np.float32), (rng.randn(2, 40, 3) * 3).astype(np.float32)
    f1, f2 = rng.randn(2, 300, 5).astype(np.float32), rng.randn(2, 40, 11).astype(np.float32)
    jmod = jmodules.PointnetFPModule(mlp=(16, 12))
    args = tuple(map(jnp.asarray, (xyz1, xyz2, f1, f2)))
    variables = _fill(jax.eval_shape(lambda *a: jmod.init(jax.random.PRNGKey(0), *a, False),
                                     *args), 9)
    want = jmod.apply(variables, *args, False)
    tmod = modules.PointnetFPModule(11 + 5, (16, 12)).eval()
    tmod.load_state_dict(flax_to_state_dict(variables), strict=True)
    with torch.inference_mode():
        got = tmod(*map(_t, (xyz1, xyz2, f1, f2)))
    _close(got.numpy(), want)


def test_global_sa_module_matches_jax():
    from ssd3d.nn import modules as jmodules

    xyz, feats = _roi_clouds(10, 6, 32, 9)
    jmod = jmodules.PointnetSAModuleGlobal(mlp=(16, 20))
    variables = _fill(jax.eval_shape(lambda a, f: jmod.init(jax.random.PRNGKey(0), a, f, False),
                                     jnp.asarray(xyz), jnp.asarray(feats)), 11)
    want = jmod.apply(variables, jnp.asarray(xyz), jnp.asarray(feats), False)
    tmod = modules.PointnetSAModuleGlobal(9, (16, 20)).eval()
    tmod.load_state_dict(flax_to_state_dict(variables), strict=True)
    with torch.inference_mode():
        got = tmod(_t(xyz), _t(feats))
    assert got.shape == (6, 20)
    _close(got.numpy(), want)


# -------------------------------------------------- kernel K7 (needs the card)

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,cf,m,ns_list,widths,agg", [
    (16, 512, 256, 128, [64], [(128, 128, 128)], None),  # RCNN SA1
    (16, 128, 128, 32, [64], [(128, 128, 256)], None),   # RCNN SA2
    (3, 200, 13, 37, [16, 32], [(16, 24), (16, 16, 32)], 40),  # ragged tile, two scales
    (4, 64, 14, 16, [16], [(300, 8)], None),  # a layer past 256: the FMA route
])
def test_sa_fused_kernel_matches_plain(cuda, b, n, cf, m, ns_list, widths, agg):
    rng, src, idx, centers, masks = _inputs(12, b, n, cf, m, ns_list)
    layers = [[tuple(_t(a).to(cuda) for a in lay) for lay in _layers(rng, cf + 3, w)]
              for w in widths]
    agg_layer = (tuple(_t(a).to(cuda) for a in _layers(rng, sum(w[-1] for w in widths), (agg,))[0])
                 if agg else None)
    args = (_t(src).to(cuda), [_t(i).to(cuda) for i in idx], _t(centers).to(cuda),
            _t(masks).to(cuda), layers, agg_layer)
    want = sa_fused.sa_fused_multi_plain(*args)
    _build.reset_launches()
    got = sa_fused.sa_fused_multi(*args)
    route = "fma" if max(max(w) for w in widths) > 256 else "wgmma"
    assert _build.route_launches()["sa_fused"] == {route: 1}
    _close(got.cpu().numpy(), want.cpu().numpy(), 1e-4)


@pytest.mark.cuda
def test_sa_fused_single_scale_kernel_is_unmasked(cuda):
    rng, src, (idx,), centers, _ = _inputs(13, 4, 256, 29, 64, [32])
    layers = [tuple(_t(a).to(cuda) for a in lay) for lay in _layers(rng, 32, (64, 64))]
    got = sa_fused.sa_fused(_t(src).to(cuda), _t(idx).to(cuda), _t(centers).to(cuda), layers)
    ones = torch.ones(4, 64, 1, device=cuda)
    want = sa_fused.sa_fused_multi_plain(_t(src).to(cuda), [_t(idx).to(cuda)],
                                         _t(centers).to(cuda), ones, [layers])
    _close(got.cpu().numpy(), want.cpu().numpy(), 1e-4)
