"""three_nn and the FP layer's interpolation: the port against the JAX package.

Inputs are made with numpy from a seed. The JAX side runs `_three_nn_jnp`
(its CPU path) and `three_nn_pallas` in interpret mode, as the JAX package's
own kernel tests run it; the port runs `three_nn_plain`, what a CPU tensor
dispatches to. Tests marked `cuda` hold kernel K6 to its plain version and
skip without a GPU.
"""

from __future__ import annotations

import functools
import importlib
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas

from ssd3d.ops import interpolate as jinterp
from ssd3d_torch.ops import _build, interpolate

# distances: both sides take exact per-coordinate differences and sum
# ((dx^2 + dy^2) + dz^2); XLA may associate the three-term sum otherwise,
# one f32 rounding apart
DIST_RTOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _clouds(seed, b, n, m):
    rng = np.random.RandomState(seed)
    return ((rng.randn(b, n, 3) * 10).astype(np.float32),
            (rng.randn(b, m, 3) * 10).astype(np.float32))


@pytest.fixture(scope="module")
def pallas_three_nn():
    """`three_nn_pallas` in interpret mode (a fresh module, so no compiled
    TPU executable is reused)."""
    orig = pallas.pallas_call
    with mock.patch.object(pallas, "pallas_call", functools.partial(orig, interpret=True)):
        import ssd3d.ops.pallas.three_nn as t

        yield importlib.reload(t).three_nn_pallas


@pytest.mark.parametrize("n,m", [(200, 64), (1500, 256), (520, 3)])
def test_three_nn_plain_matches_jax(n, m):
    """n > 1024 crosses a chunk boundary of both sides; m = 3 fills all slots."""
    unknown, known = _clouds(n + m, 2, n, m)
    want_d, want_i = jinterp._three_nn_jnp(jnp.asarray(unknown), jnp.asarray(known))
    got_d, got_i = interpolate.three_nn(_t(unknown), _t(known))
    assert got_i.dtype == torch.int32 and got_i.shape == (2, n, 3)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=DIST_RTOL, atol=0)
    assert (np.diff(got_d.numpy(), axis=-1) >= 0).all()  # nearest first


@pytest.mark.parametrize("n,m", [(200, 64), (256, 96), (520, 256)])
def test_three_nn_plain_matches_the_pallas_kernel(pallas_three_nn, n, m):
    unknown, known = _clouds(7 * n + m, 2, n, m)
    want_d, want_i = pallas_three_nn(jnp.asarray(unknown), jnp.asarray(known))
    got_d, got_i = interpolate.three_nn_plain(_t(unknown), _t(known))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=DIST_RTOL, atol=0)


def test_three_nn_ties_fill_slots_in_index_order(pallas_three_nn):
    """Duplicated knowns (groups of 4 identical points): equal distances take
    the slots in index order, as the reference CUDA scan does."""
    known = np.zeros((1, 64, 3), np.float32)
    known[0, :, 0] = np.arange(64) // 4
    unknown = np.zeros((1, 8, 3), np.float32)
    unknown[0, :, 0] = np.arange(8) * 2.0 + 0.25
    got_d, got_i = interpolate.three_nn(_t(unknown), _t(known))
    want_d, want_i = pallas_three_nn(jnp.asarray(unknown), jnp.asarray(known))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    assert got_i[0, 0].tolist() == [0, 1, 2]
    jd, ji = jinterp._three_nn_jnp(jnp.asarray(unknown), jnp.asarray(known))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ji))


def test_three_nn_takes_no_gradient_and_checks_its_inputs():
    unknown, known = _clouds(3, 1, 10, 5)
    q = _t(unknown).requires_grad_(True)
    d, _ = interpolate.three_nn(q, _t(known))
    assert not d.requires_grad
    with pytest.raises(ValueError, match="at least 3 knowns"):
        interpolate.three_nn(_t(unknown), _t(known)[:, :2])
    with pytest.raises(ValueError, match="f32"):
        interpolate.three_nn(_t(unknown).double(), _t(known))


def test_inverse_distance_weights_and_three_interpolate_match_jax():
    rng = np.random.RandomState(5)
    unknown, known = _clouds(5, 2, 300, 40)
    known[0, 0] = unknown[0, 0]  # a zero distance: the eps clamp
    feats = rng.randn(2, 40, 37).astype(np.float32)
    d2, idx = jinterp._three_nn_jnp(jnp.asarray(unknown), jnp.asarray(known))
    want_w = jinterp.inverse_distance_weights(d2)
    got_w = interpolate.inverse_distance_weights(_t(d2))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=1e-6, atol=1e-7)
    want = jinterp.three_interpolate(jnp.asarray(feats), idx, want_w)
    got = interpolate.three_interpolate(_t(feats), _t(idx), _t(want_w))
    # a sum of three products: at most one rounding apart per term
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_three_nn_cpu_takes_the_plain_version():
    _build.reset_launches()
    unknown, known = _clouds(6, 1, 20, 8)
    interpolate.three_nn(_t(unknown), _t(known))
    assert _build.launches()["three_nn"] == 0


# -------------------------------------------------- kernel K6 (needs the card)

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(16384, 4096), (4096, 1024), (1000, 3), (300, 2500)])
def test_three_nn_kernel_equals_plain(cuda, n, m):
    """Indices equal, distances bit-identical (both round every operation)."""
    unknown, known = _clouds(n, 2, n, m)
    want_d, want_i = interpolate.three_nn_plain(_t(unknown).to(cuda), _t(known).to(cuda))
    _build.reset_launches()
    got_d, got_i = interpolate.three_nn(_t(unknown).to(cuda), _t(known).to(cuda))
    assert _build.launches()["three_nn"] == 1
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_d, want_d)


@pytest.mark.cuda
def test_three_nn_kernel_takes_more_clouds_than_a_grid_column(cuda):
    """b > 65,535 (the grid's y limit): the kernel loops over the clouds."""
    b = 65535 + 2
    unknown, known = _clouds(38, b, 5, 4)
    want_d, want_i = interpolate.three_nn_plain(_t(unknown), _t(known))
    got_d, got_i = interpolate.three_nn(_t(unknown).to(cuda), _t(known).to(cuda))
    assert torch.equal(got_i.cpu(), want_i)
    assert torch.equal(got_d.cpu(), want_d)


@pytest.mark.cuda
def test_three_nn_kernel_tie_order(cuda):
    known = np.zeros((1, 64, 3), np.float32)
    known[0, :, 0] = np.arange(64) // 4
    unknown = np.zeros((1, 8, 3), np.float32)
    got_d, got_i = interpolate.three_nn(_t(unknown).to(cuda), _t(known).to(cuda))
    assert got_i[0, 0].tolist() == [0, 1, 2] and got_d[0, 0].tolist() == [0.0, 0.0, 0.0]
