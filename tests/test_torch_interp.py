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


def _before(d, i, e, j):
    """csrc/three_nn.cu `before`: (d, i) ahead of (e, j)."""
    return (d < e) | ((d == e) & (i < j))


def _insert_merge(lst, d, k):
    """csrc/three_nn.cu `insert_merge` on tensors: candidate (d, k) into the
    sorted 3-list lst = [d0, d1, d2, i0, i1, i2]."""
    d0, d1, d2, i0, i1, i2 = lst
    b2 = _before(d, k, d2, i2)
    b1 = b2 & _before(d, k, d1, i1)
    b0 = b1 & _before(d, k, d0, i0)
    return [torch.where(b0, d, d0), torch.where(b0, d0, torch.where(b1, d, d1)),
            torch.where(b1, d1, torch.where(b2, d, d2)),
            torch.where(b0, k, i0), torch.where(b0, i0, torch.where(b1, k, i1)),
            torch.where(b1, i1, torch.where(b2, k, i2))]


def three_nn_split_merge(unknown, known, s):
    """K6's split and merge on the CPU: the knowns in s slices of
    ceil(m / s) contiguous indices, each slice's 3-best by `three_nn_plain`
    (a slice's missing slots, as the kernel's, (inf, 0)), then the lanes'
    butterfly (xor 1, 2, 4) inserting the partner's candidates in order."""
    b, n, _ = unknown.shape
    m = known.shape[1]
    per = -(-m // s)
    lists = []
    for sl in range(s):
        part = known[:, sl * per:(sl + 1) * per]
        d = torch.full((b, n, 3), float("inf"))
        i = torch.zeros(b, n, 3, dtype=torch.int32)
        if part.shape[1]:
            pd, pi = interpolate.three_nn_plain(unknown, part)
            k = min(3, part.shape[1])
            d[..., :k], i[..., :k] = pd[..., :k], pi[..., :k] + sl * per
        lists.append([d[..., 0], d[..., 1], d[..., 2], i[..., 0], i[..., 1], i[..., 2]])
    off = 1
    while off < s:
        merged = []
        for sl in range(s):
            lst, other = lists[sl], lists[sl ^ off]
            for r in range(3):
                lst = _insert_merge(lst, other[r], other[3 + r])
            merged.append(lst)
        lists, off = merged, 2 * off
    d0, d1, d2, i0, i1, i2 = lists[0]
    return torch.stack([d0, d1, d2], -1), torch.stack([i0, i1, i2], -1)


def _tied_clouds(seed, b, n, m):
    """Knowns on a small integer lattice, each repeated at several indices a
    third of the cloud apart (so copies fall in different slices), unknowns
    on the lattice and at half steps: equal distances everywhere, across
    slice borders too."""
    rng = np.random.RandomState(seed)
    base = rng.randint(-3, 4, size=(b, -(-m // 3), 3)).astype(np.float32)
    known = np.concatenate([base, base[:, ::-1], base], axis=1)[:, :m].copy()
    unknown = (rng.randint(-6, 7, size=(b, n, 3)) * 0.5).astype(np.float32)
    return unknown, known


@pytest.mark.parametrize("s", [1, 2, 4, 8])
@pytest.mark.parametrize("n,m", [(256, 64), (200, 96), (130, 65)])
def test_three_nn_split_merge_equals_one_scan(pallas_three_nn, n, m, s):
    """K6's S slices merged by (d, index) give one scan's result, ties
    included: the plain version's and the Pallas kernel's (interpret mode).
    m = 65 leaves the last of 8 slices two knowns."""
    unknown, known = _tied_clouds(n + m + s, 2, n, m)
    got_d, got_i = three_nn_split_merge(_t(unknown), _t(known), s)
    plain_d, plain_i = interpolate.three_nn_plain(_t(unknown), _t(known))
    want_d, want_i = pallas_three_nn(jnp.asarray(unknown), jnp.asarray(known))
    assert torch.equal(got_i, plain_i) and torch.equal(got_d, plain_d)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    # the input has ties that cross slices: some unknown's kept knowns are
    # equally near and lie in different slices
    per = -(-m // s)
    tied = (got_d[..., 0] == got_d[..., 1]) & (got_i[..., 0] // per != got_i[..., 1] // per)
    assert s == 1 or bool(tied.any())


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
@pytest.mark.parametrize("s", [1, 2, 4, 8])
@pytest.mark.parametrize("n,m", [(4096, 1024), (777, 65), (300, 2500), (5, 16387)])
def test_three_nn_kernel_every_slicing_on_ties(cuda, n, m, s, monkeypatch):
    """Every S the kernel takes, on knowns repeated across slice borders
    (m = 65: a last slice of 2 knowns; 16,387: slices over several tiles
    with a partial last chunk): indices equal the plain version's,
    distances bit-identical."""
    monkeypatch.setattr(interpolate, "three_nn_slices", lambda b, n_, m_: s)
    unknown, known = _tied_clouds(n + m, 2, n, m)
    xyz1, xyz2 = _t(unknown).to(cuda), _t(known).to(cuda)
    want_d, want_i = interpolate.three_nn_plain(xyz1, xyz2)
    got_d, got_i = interpolate.three_nn(xyz1, xyz2)
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_d, want_d)


@pytest.mark.cuda
def test_three_nn_kernel_tie_order(cuda):
    known = np.zeros((1, 64, 3), np.float32)
    known[0, :, 0] = np.arange(64) // 4
    unknown = np.zeros((1, 8, 3), np.float32)
    got_d, got_i = interpolate.three_nn(_t(unknown).to(cuda), _t(known).to(cuda))
    assert got_i[0, 0].tolist() == [0, 1, 2] and got_d[0, 0].tolist() == [0.0, 0.0, 0.0]
