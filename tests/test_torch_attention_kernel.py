"""K9, the attention-ordered ball query (`torch.ops.ssd3d.ball_query_attention`,
`ssd3d_torch/csrc/ball_query_attention.cu`).

On the CPU the op runs its plain version (`ops.grouping.ball_query_attention_plain`):
`ops.grouping.ball_query_attention` through it is held to the JAX package's
`ball_query_attention` (idx and cnt equal) on tie-heavy feature keys, on balls
smaller than ns and on empty balls; the op itself is held to a direct
per-query selection in numpy on keys that reach both ends of int32, and
passes `torch.library.opcheck`. Tests marked `cuda` hold the kernel to the
plain version bit for bit on the card, on both of its tiers (a ball in shared
memory, and one past it that streams the cloud); they skip without a card.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd3d.ops import grouping as jgrouping
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


def _keys(seed, b, m, n, kind):
    rng = np.random.RandomState(seed)
    if kind == "extremes":  # both ends of int32, and ties at them
        return rng.choice([INT32_MIN, INT32_MIN + 1, -1, 0, 1, INT32_MAX - 1, INT32_MAX],
                          size=(b, m, n)).astype(np.int32)
    if kind == "ties":
        return rng.randint(-3, 3, size=(b, m, n)).astype(np.int32)
    return rng.randint(INT32_MIN, INT32_MAX, size=(b, m, n), dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("kind", ["uniform", "ties", "extremes"])
@pytest.mark.parametrize("radius,ns", [(0.5, 4), (1.5, 16), (3.0, 32)])
def test_op_is_the_contract(radius, ns, kind):
    xyz, q, _, _ = _cloud(3, n=300, m=40, far=5)
    key = _keys(4, 2, 40, 300, kind)
    r2 = float(np.float32(radius * radius))
    want_i, want_c = _select(xyz, q, key, r2, ns)
    got_i, got_c = torch.ops.ssd3d.ball_query_attention(_t(xyz), _t(q), _t(key), r2, ns)
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    np.testing.assert_array_equal(got_i.numpy(), want_i)


def test_op_passes_opcheck():
    xyz, q, _, _ = _cloud(5, n=200, m=30, far=3)
    key = _t(_keys(6, 2, 30, 200, "ties"))
    torch.library.opcheck(torch.ops.ssd3d.ball_query_attention,
                          (_t(xyz), _t(q), key, float(np.float32(1.0)), 8))


# -------------------------------------------------- the kernel (needs the card)

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _kernel_vs_plain(xyz, q, key, r2, ns, dev):
    want = grouping.ball_query_attention_plain(xyz, q, key, r2, ns)
    _build.reset_launches()
    got = torch.ops.ssd3d.ball_query_attention(xyz.to(dev), q.to(dev), key.to(dev), r2, ns)
    torch.cuda.synchronize()
    assert _build.launches()["ball_query_attention"] == 1
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g.cpu(), w)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [grouping._ATTN_SMEM_CAP, 5, 0])
@pytest.mark.parametrize("kind", ["uniform", "ties", "extremes"])
@pytest.mark.parametrize("radius,ns", [(0.5, 4), (1.5, 16), (3.0, 32), (6.0, 700)])
def test_kernel_equals_plain(cuda, radius, ns, kind, cap, monkeypatch):
    """At the default tier and with the shared tier cut to 5 and 0 members
    (every larger ball streams its cloud)."""
    monkeypatch.setattr(grouping, "_ATTN_SMEM_CAP", cap)
    xyz, q, _, _ = _cloud(7, n=3000, m=200, far=20)
    key = _t(_keys(8, 2, 200, 3000, kind))
    _kernel_vs_plain(_t(xyz), _t(q), key, float(np.float32(radius * radius)), ns, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["uniform", "ties"])
def test_kernel_past_the_shared_tier(cuda, kind):
    """Balls of up to 30,000 members (the whole cloud), past the shared tier's
    4,096: the streaming tier at its real size."""
    xyz, q, _, _ = _cloud(9, b=1, n=30000, m=48, far=4)
    key = _t(_keys(10, 1, 48, 30000, kind))
    _, cnt = _kernel_vs_plain(_t(xyz), _t(q), key, 400.0, 64, cuda)
    assert int(cnt[0, 0]) == 64


@pytest.mark.cuda
def test_public_query_on_the_card_equals_plain(cuda):
    """`ball_query_attention` on CUDA tensors: its keys on the card, then K9,
    equal to the plain version fed the same keys."""
    xyz, q, f, nf = map(_t, _cloud(11, n=2048, m=512, cf=8, levels=3))
    r2 = float(np.float32(0.8 * 0.8))
    got = grouping.ball_query_attention(0.8, 32, *(a.to(cuda) for a in (xyz, q, f, nf)))
    key = grouping._order_key(grouping.square_distance(nf.to(cuda), f.to(cuda))).cpu()
    want = grouping.ball_query_attention_plain(xyz, q, key, r2, 32)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
