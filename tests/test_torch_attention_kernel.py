"""K9, the attention-ordered ball query (`torch.ops.ssd3d.ball_query_attention`,
`ssd3d_torch/csrc/ball_query_attention.cu`).

The op takes the features and their squared norms and computes each
member's key itself. On the CPU it runs its plain version
(`ops.grouping.ball_query_attention_plain`): `ops.grouping.ball_query_attention`
through it is held to the JAX package's `ball_query_attention` (idx and cnt
equal) on tie-heavy features, on balls smaller than ns and on empty balls; the
op itself is held to a direct per-query selection in numpy, on keys summed in
channel order in numpy from features that are random, duplicated rows (ties)
or extreme (keys near both ends of int32), and passes `torch.library.opcheck`;
its keys are `_order_key(square_distance(...))` bit for bit at one channel.
Tests marked `cuda` hold the kernel to the plain version bit for bit on the
card, on each of its tiers (the query tile, the ball list in shared memory,
the ball list streaming the cloud), forced by the caps `_ATTN_TILE_CAP` and
`_ATTN_SMEM_CAP`; they skip without a card.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd3d.ops import grouping as jgrouping
from ssd3d_torch.core.geometry import square_distance
from ssd3d_torch.ops import _build, grouping

INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1


def _t(a):
    return torch.from_numpy(np.array(a))


def _cloud(seed, b=2, n=500, m=60, cf=4, levels=0, far=0):
    """xyz [b, n, 3] and the first m points as queries, features [b, n, cf];
    with `levels`, features take that many values (many equal feature
    distances: threshold ties); the last `far` queries lie 100 m away (empty
    balls)."""
    rng = np.random.RandomState(seed)
    xyz = (rng.randn(b, n, 3) * 1.5).astype(np.float32)
    feats = rng.randn(b, n, cf)
    if levels:
        feats = rng.randint(0, levels, size=(b, n, cf)).astype(np.float64)
    feats = feats.astype(np.float32)
    q = xyz[:, :m].copy()
    if far:
        q[:, m - far:] += 100.0
    return xyz, q, feats, feats[:, :m].copy()


@pytest.mark.parametrize("levels", [0, 2, 3])
@pytest.mark.parametrize("radius,ns", [(0.3, 8), (1.0, 16), (2.0, 64), (4.0, 600)])
def test_equals_jax(radius, ns, levels):
    """Tie-heavy keys (features of 2 or 3 levels), balls below ns (radius 0.3,
    ns 600 past the cloud) and 10 empty balls a cloud."""
    xyz, q, f, nf = _cloud(levels * 10 + int(radius * 10), levels=levels, far=10)
    wi, wc = jgrouping.ball_query_attention(radius, ns, *map(jnp.asarray, (xyz, q, f, nf)))
    gi, gc = grouping.ball_query_attention(radius, ns, *map(_t, (xyz, q, f, nf)))
    assert gi.dtype == gc.dtype == torch.int32 and gi.shape == (2, 60, ns)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    assert (gc[:, -10:] == 0).all() and (gi[:, -10:] == 0).all()  # empty balls: all 0
    assert (gc[:, :-10] >= 1).all()  # each other centre is a point of its ball


def _select(xyz, q, key, r2, ns):
    """The contract written out, one query at a time: the in-radius points,
    T the ns-th largest key (INT32_MIN below ns members); those above T in
    index order, then T's ties in index order, up to ns; padded with the
    largest key's lowest index; all 0 for an empty ball."""
    b, m = q.shape[:2]
    idx = np.zeros((b, m, ns), np.int32)
    cnt = np.zeros((b, m), np.int32)
    for bi in range(b):
        d = q[bi, :, None, :] - xyz[bi, None, :, :]
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
        for qi in range(m):
            members = np.nonzero(d2[qi] < np.float32(r2))[0]
            if not len(members):
                continue
            keys = key[bi, qi, members].astype(np.int64)
            t = np.sort(keys)[::-1][ns - 1] if len(members) >= ns else INT32_MIN
            sel = list(members[keys > t]) + list(members[keys == t])
            sel = sel[:ns]
            first = members[np.argmax(keys)]  # argmax: the first maximal
            cnt[bi, qi] = len(sel)
            idx[bi, qi] = sel + [first] * (ns - len(sel))
    return idx, cnt


def _feats(seed, b, n, m, kind, cf=4):
    """Features [b, n, cf] and the queries' (the first m rows): "uniform"
    normal; "ties" rows drawn from 3 distinct rows (equal keys); "extremes"
    entries from 0, +-1e-30, +-1 and +-1e18 (keys near both ends of int32,
    and cancellations that round to 0 or below)."""
    rng = np.random.RandomState(seed)
    if kind == "ties":
        f = rng.randn(b, 3, cf)[np.arange(b)[:, None], rng.randint(0, 3, size=(b, n))]
    elif kind == "extremes":
        f = rng.choice([0.0, 1e-30, -1e-30, 1.0, -1.0, 1e18, -1e18], size=(b, n, cf))
    else:
        f = rng.randn(b, n, cf)
    f = f.astype(np.float32)
    return f, f[:, :m].copy()


def _norms(f, nf):
    """The squared norms as `ball_query_attention` sums them."""
    f, nf = _t(f), _t(nf)
    return (nf * nf).sum(-1).float(), (f * f).sum(-1).float()


def _np_keys(f, nf, a_sq, b_sq):
    """The keys written out in numpy f32: cross summed in channel order from
    0, then the signed order key of (a_sq + b_sq) - 2 * cross."""
    f, nf = np.asarray(f, np.float32), np.asarray(nf, np.float32)
    cross = np.zeros((nf.shape[0], nf.shape[1], f.shape[1]), np.float32)
    for c in range(f.shape[-1]):
        cross = cross + nf[:, :, None, c] * f[:, None, :, c]
    d = (np.asarray(a_sq)[..., None] + np.asarray(b_sq)[:, None, :]) - np.float32(2.0) * cross
    bits = d.astype(np.float32).view(np.int32)
    return np.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


@pytest.mark.parametrize("kind", ["uniform", "ties", "extremes"])
@pytest.mark.parametrize("radius,ns", [(0.5, 4), (1.5, 16), (3.0, 32)])
def test_op_is_the_contract(radius, ns, kind):
    xyz, q, _, _ = _cloud(3, n=300, m=40, far=5)
    f, nf = _feats(4, 2, 300, 40, kind)
    a_sq, b_sq = _norms(f, nf)
    r2 = float(np.float32(radius * radius))
    want_i, want_c = _select(xyz, q, _np_keys(f, nf, a_sq, b_sq), r2, ns)
    got_i, got_c = torch.ops.ssd3d.ball_query_attention(_t(xyz), _t(q), _t(f), _t(nf), a_sq,
                                                        b_sq, r2, ns)
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    np.testing.assert_array_equal(got_i.numpy(), want_i)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_keys_at_one_channel_are_square_distance_keys(dtype):
    """At one channel (SA1's) the cross term is one product, so the plain
    keys equal the order keys of `square_distance` bit for bit."""
    f = _t(np.random.RandomState(12).randn(2, 300, 1).astype(np.float32) * 3).to(dtype)
    nf = f[:, :40]
    a_sq, b_sq = (nf * nf).sum(-1).float(), (f * f).sum(-1).float()
    got = grouping.attention_keys(nf, f, a_sq, b_sq)
    assert got.dtype == torch.int32 and got.shape == (2, 40, 300)
    assert torch.equal(got, grouping._order_key(square_distance(nf, f)))


def test_op_passes_opcheck():
    xyz, q, _, _ = _cloud(5, n=200, m=30, far=3)
    f, nf = _feats(6, 2, 200, 30, "ties")
    torch.library.opcheck(torch.ops.ssd3d.ball_query_attention,
                          (_t(xyz), _t(q), _t(f), _t(nf), *_norms(f, nf),
                           float(np.float32(1.0)), 8))


# -------------------------------------------------- the kernel (needs the card)

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# K9's tiers by (_ATTN_TILE_CAP, _ATTN_SMEM_CAP): the defaults (query tiles,
# larger balls listed), every ball listed, balls past 5 members listed and
# streamed, every ball listed and streamed
TIERS = {"tile": (grouping._ATTN_TILE_CAP, grouping._ATTN_SMEM_CAP), "list": (0, 4096),
         "tile5_stream": (5, 5), "stream": (0, 0)}


def _kernel_vs_plain(xyz, q, f, nf, r2, ns, dev):
    """K9 on the card against the plain op on the CPU, both given the same
    inputs and norms (the norms summed on the CPU)."""
    a_sq, b_sq = (nf.float() * nf.float()).sum(-1), (f.float() * f.float()).sum(-1)
    want = torch.ops.ssd3d.ball_query_attention(xyz, q, f, nf, a_sq, b_sq, r2, ns)
    _build.reset_launches()
    got = torch.ops.ssd3d.ball_query_attention(*(t.to(dev) for t in (xyz, q, f, nf, a_sq, b_sq)),
                                               r2, ns)
    torch.cuda.synchronize()
    assert _build.launches()["ball_query_attention"] == 1
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g.cpu(), w)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("kind", ["uniform", "ties", "extremes"])
@pytest.mark.parametrize("radius,ns", [(0.5, 4), (1.5, 16), (3.0, 32), (6.0, 700)])
def test_kernel_equals_plain(cuda, radius, ns, kind, tier, monkeypatch):
    """On each tier, with 200 queries (a ragged last query tile) and 20 empty
    balls a cloud."""
    monkeypatch.setattr(grouping, "_ATTN_TILE_CAP", TIERS[tier][0])
    monkeypatch.setattr(grouping, "_ATTN_SMEM_CAP", TIERS[tier][1])
    xyz, q, _, _ = _cloud(7, n=3000, m=200, far=20)
    f, nf = _feats(8, 2, 3000, 200, kind)
    _kernel_vs_plain(*map(_t, (xyz, q, f, nf)), float(np.float32(radius * radius)), ns, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("cf", [1, 64])
def test_kernel_equals_plain_bf16(cuda, cf, tier, monkeypatch):
    """bf16 features (widened exactly) at SA1's and SA2's widths."""
    monkeypatch.setattr(grouping, "_ATTN_TILE_CAP", TIERS[tier][0])
    monkeypatch.setattr(grouping, "_ATTN_SMEM_CAP", TIERS[tier][1])
    xyz, q, _, _ = _cloud(13, n=2000, m=100, far=4)
    f, nf = (_t(a).to(torch.bfloat16) for a in _feats(14, 2, 2000, 100, "uniform", cf=cf))
    _kernel_vs_plain(_t(xyz), _t(q), f, nf, float(np.float32(1.2 * 1.2)), 32, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["uniform", "ties"])
def test_kernel_past_the_shared_tier(cuda, kind):
    """Balls of up to 30,000 members (the whole cloud), past the query
    tile's 128 and the shared tier's 4,096: the streaming tier at its real
    size, at the default caps."""
    xyz, q, _, _ = _cloud(9, b=1, n=30000, m=48, far=4)
    f, nf = _feats(10, 1, 30000, 48, kind)
    _, cnt = _kernel_vs_plain(*map(_t, (xyz, q, f, nf)), 400.0, 64, cuda)
    assert int(cnt[0, 0]) == 64


@pytest.mark.cuda
def test_public_query_on_the_card_equals_plain(cuda):
    """`ball_query_attention` on CUDA tensors (its norms on the card, then
    K9) equal to the plain op fed the same norms."""
    xyz, q, f, nf = (_t(a).to(cuda) for a in _cloud(11, n=2048, m=512, cf=8, levels=3))
    got = grouping.ball_query_attention(0.8, 32, xyz, q, f, nf)
    a_sq, b_sq = (nf * nf).sum(-1).float(), (f * f).sum(-1).float()
    want = grouping.ball_query_attention_plain(*(t.cpu() for t in (xyz, q, f, nf, a_sq, b_sq)),
                                               float(np.float32(0.8 * 0.8)), 32)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
