"""Neighbourhood grouping: the multi-ring ball query, the attention-ordered
and caller-ordered ball queries, k nearest neighbours, the grouping gather
and the rotated-box interior query of the RoI pool.

Counterpart of `ssd3d/ops/grouping.py` (`ball_query_multi`, `ball_query`,
`ball_query_dilated`, `ball_query_attention`, `ball_query_withidx`,
`knn_points`, `group_points`, `query_boxes_3d_points`,
`query_boxes_3d_mask`, `query_points_iou`).
Each kernel-backed function calls its custom op (`ops/library.py`), which
dispatches on the device of its inputs: CUDA tensors launch the
hand-written kernel (`csrc/ball_query.cu` on one of its two routes,
`csrc/gather.cu`, and for the gather's backward `csrc/scatter_add.cu`),
CPU tensors take the plain PyTorch version beside it.
The attention-ordered ball query is a custom op too: `csrc/ball_query_attention.cu`
(K9) on the card, its plain version on the CPU; the JAX package computes it
in XLA. The caller-ordered ball query, the k-NN, the box queries and the
point IoU are plain PyTorch on every device, as they are plain XLA in the
JAX package.

The ball-query contract is the reference CUDA one (tf_grouping_g.cu:215-255,
:308-357): per ring, the first `ns` points in index order inside the ring,
padded by repeating the first hit, `cnt` capped at `ns`, and `idx` all zero
for an empty ball. The TPU's packed-word selection machinery exists only to
express that first-k rule on a TPU and has no counterpart here.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ssd3d_torch.core.geometry import canonicalize_points
from ssd3d_torch.ops import _build

_QUERY_CHUNK = 256  # plain version: queries per chunk, bounds the [b, chunk, n] tensors


def ring_specs(radius_list, nsample_list, dilated: bool):
    """[(lo2, hi2, ns, annulus)] per ring, as `ball_query_multi` defines them.
    lo2 / hi2 are rounded to float32 once, as the comparisons against f32 d2
    do in both frameworks."""
    specs = []
    for i, (r, ns) in enumerate(zip(radius_list, nsample_list)):
        lo = radius_list[i - 1] if (dilated and i > 0) else 0.0
        specs.append((float(np.float32(lo * lo)), float(np.float32(r * r)),
                      int(ns), dilated and i > 0))
    return specs


def _pairwise_dist2(queries: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """[b, m, 3] x [b, n, 3] -> [b, m, n], ((dx*dx + dy*dy) + dz*dz)."""
    d = queries[:, :, None, :] - points[:, None, :, :]
    dx, dy, dz = d.unbind(-1)
    return (dx * dx + dy * dy) + dz * dz


def _first_k(valid: torch.Tensor, ns: int):
    """First `ns` true entries of each row of valid [..., n], in index order,
    padded with the first hit (0 when none) -> (idx int32 [..., ns], cnt)."""
    n = valid.shape[-1]
    iota = torch.arange(n, device=valid.device)
    key = torch.where(valid, iota, n + iota)
    if ns > n:
        key = torch.cat([key, key.new_full(key.shape[:-1] + (ns - n,), 2 * n)], -1)
    first = key.topk(ns, dim=-1, largest=False, sorted=True).values
    cnt = valid.sum(-1).clamp(max=ns)
    slots = torch.arange(ns, device=valid.device)
    idx = torch.where(slots < cnt[..., None], first, first[..., :1])
    idx = torch.where(cnt[..., None] > 0, idx, torch.zeros_like(idx))
    return idx.to(torch.int32), cnt.to(torch.int32)


def ball_query_multi_plain(specs, xyz: torch.Tensor, new_xyz: torch.Tensor):
    """Plain multi-ring ball query: [(idx [b, m, ns], cnt [b, m])] per ring."""
    m = new_xyz.shape[1]
    parts = [[] for _ in specs]
    for q0 in range(0, m, _QUERY_CHUNK):
        d2 = _pairwise_dist2(new_xyz[:, q0:q0 + _QUERY_CHUNK], xyz)
        for k, (lo2, hi2, ns, annulus) in enumerate(specs):
            if annulus:
                valid = ((d2 >= lo2) & (d2 < hi2)) | (d2 == 0.0)
            else:
                valid = d2 < hi2
            parts[k].append(_first_k(valid, ns))
    return [(torch.cat([p[0] for p in ring], 1), torch.cat([p[1] for p in ring], 1))
            for ring in parts]


# K3 has two routes (csrc/ball_query.cu): a uniform grid built per call, or a
# brute-force scan of the cloud. The grid's cell is at least the outer radius
# (from the f32 hi2 it is compared against) times 1 + GRID_MARGIN: a pair
# inside a ring differs by less than the radius times 1 + 1e-7 along each
# axis, and cells are computed in double precision, so a 1% margin keeps
# every hit within one cell of its query. A cloud takes at most
# grid_cell_cap(n) cells (the build grows the cell past that), and the grid
# route at most GRID_MAX_POINTS points: the build sorts 16-bit cells and
# indices in shared memory.
GRID_MARGIN = 0.01
GRID_MAX_POINTS = 16384
GRID_MAX_CELLS = 65536
# The grid route from this many points a cloud up (chip_smoke.py phases 2
# and 7 time both routes at every shape of the three paths; PERF.md §6).
GRID_MIN_POINTS = 2048


def grid_cell_min(specs) -> float:
    """The grid's least cell edge for these rings: the largest sqrt(hi2)
    times 1 + GRID_MARGIN."""
    return math.sqrt(max(s[1] for s in specs)) * (1.0 + GRID_MARGIN)


def grid_cell_cap(n: int) -> int:
    """Cells a cloud of n points may take: four a point, at least 64, at
    most GRID_MAX_CELLS (a cell is a 16-bit key)."""
    return min(GRID_MAX_CELLS, max(64, 4 * n))


def ball_query_route(n: int) -> str:
    """K3's route for clouds of n points: "grid" or "brute"."""
    return "grid" if GRID_MIN_POINTS <= n <= GRID_MAX_POINTS else "brute"


# K3 takes at most this many rings a launch (csrc/ball_query.cu)
KERNEL_MAX_RINGS = 4


def ring_groups(specs) -> list:
    """The rings in groups of at most KERNEL_MAX_RINGS, in order, one launch
    of K3 each: a ring's idx and cnt depend on its own (lo2, hi2, ns,
    annulus) only, which each group keeps as `ring_specs` gave them."""
    return [specs[i:i + KERNEL_MAX_RINGS] for i in range(0, len(specs), KERNEL_MAX_RINGS)]


@_build.on_input_device
def _ball_query_cuda(specs, xyz: torch.Tensor, new_xyz: torch.Tensor):
    """K3 on the route `ball_query_route` picks (tests and timing patch it to
    force one), one launch for each group of `ring_groups` -> (idx int32
    [b, m, sum of ns], cnt int32 [b, m, rings]), the rings side by side."""
    parts = [_ball_query_launch(group, xyz, new_xyz) for group in ring_groups(specs)]
    if len(parts) == 1:
        return parts[0]
    return torch.cat([p[0] for p in parts], -1), torch.cat([p[1] for p in parts], -1)


def _ball_query_launch(specs, xyz: torch.Tensor, new_xyz: torch.Tensor):
    """One launch of K3 for at most KERNEL_MAX_RINGS rings -> (idx, cnt)
    with the rings side by side."""
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    k = len(specs)
    route = ball_query_route(n)
    if route not in ("grid", "brute"):
        raise ValueError(f"ball_query_multi: unknown route {route!r}")
    if route == "grid" and n > GRID_MAX_POINTS:
        raise ValueError(f"ball_query_multi: the grid route takes n <= {GRID_MAX_POINTS}, got {n}")
    xyz, new_xyz = xyz.contiguous(), new_xyz.contiguous()
    ns_list = [s[2] for s in specs]
    idx = torch.empty(b, m, sum(ns_list), dtype=torch.int32, device=xyz.device)
    cnt = torch.empty(b, m, k, dtype=torch.int32, device=xyz.device)
    lo2 = (ctypes.c_float * k)(*[s[0] for s in specs])
    hi2 = (ctypes.c_float * k)(*[s[1] for s in specs])
    ann = (ctypes.c_int * k)(*[int(s[3]) for s in specs])
    nsa = (ctypes.c_int * k)(*ns_list)
    grids = cell_start = points_by_cell = None  # the grid route's scratch
    cap, cell_min = 0, 0.0
    if route == "grid":
        cap, cell_min = grid_cell_cap(n), grid_cell_min(specs)
        grids = torch.empty(b, 8, dtype=torch.float64, device=xyz.device)
        cell_start = torch.empty(b, cap + 1, dtype=torch.int32, device=xyz.device)
        points_by_cell = torch.empty(b, n, 4, dtype=torch.float32, device=xyz.device)
    _build.BALL_QUERY(
        xyz.data_ptr(), new_xyz.data_ptr(), idx.data_ptr(), cnt.data_ptr(),
        b, n, m, k,
        ctypes.cast(lo2, ctypes.c_void_p), ctypes.cast(hi2, ctypes.c_void_p),
        ctypes.cast(ann, ctypes.c_void_p), ctypes.cast(nsa, ctypes.c_void_p),
        int(route == "grid"),
        *[t.data_ptr() if t is not None else None for t in (grids, cell_start, points_by_cell)],
        cap, cell_min, route=route,
    )
    return idx, cnt


def ball_query_multi(radius_list, nsample_list, xyz: torch.Tensor,
                     new_xyz: torch.Tensor, dilated: bool = False):
    """All radius scales of one SA layer from one distance pass.

    xyz: f32 [b, n, 3]; new_xyz: f32 [b, m, 3] -> list per radius of
    (idx int32 [b, m, ns], cnt int32 [b, m]). With dilated=True, scale i > 0
    selects the annulus r_{i-1} <= d < r_i plus the d == 0 self point."""
    return _ball_query_specs("ball_query_multi", ring_specs(radius_list, nsample_list, dilated),
                             xyz, new_xyz)


def _ball_query_specs(op: str, specs, xyz: torch.Tensor, new_xyz: torch.Tensor):
    for name, t in (("xyz", xyz), ("new_xyz", new_xyz)):
        if t.dim() != 3 or t.shape[-1] != 3 or t.dtype != torch.float32:
            raise ValueError(f"{op}: {name} must be f32 [b, *, 3]")
    if xyz.shape[0] != new_xyz.shape[0]:
        raise ValueError(f"{op}: batch {xyz.shape[0]} != {new_xyz.shape[0]}")
    _build.require_cuda(op, xyz, new_xyz)
    idx, cnt = torch.ops.ssd3d.ball_query(xyz, new_xyz, [s[0] for s in specs],
                                          [s[1] for s in specs], [s[2] for s in specs],
                                          [s[3] for s in specs])
    out, off = [], 0
    for r, (_, _, ns, _) in enumerate(specs):
        out.append((idx[..., off:off + ns], cnt[..., r]))
        off += ns
    return out


def ball_query(radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor):
    """The first `nsample` points with d < radius, in index order: xyz
    [b, n, 3], new_xyz [b, m, 3] -> (idx int32 [b, m, nsample], cnt [b, m]).
    One ring of `ball_query_multi` (K3 on the card)."""
    return ball_query_multi([radius], [nsample], xyz, new_xyz)[0]


def ball_query_dilated(min_radius: float, max_radius: float, nsample: int,
                       xyz: torch.Tensor, new_xyz: torch.Tensor):
    """The annulus min_radius <= d < max_radius, the d == 0 self point always
    in (3DSSD's dilated grouping): -> (idx int32 [b, m, nsample], cnt
    [b, m]). One annulus ring of K3 on the card."""
    spec = (float(np.float32(min_radius * min_radius)),
            float(np.float32(max_radius * max_radius)), int(nsample), True)
    return _ball_query_specs("ball_query_dilated", [spec], xyz, new_xyz)[0]


def _check_query(op: str, xyz: torch.Tensor, new_xyz: torch.Tensor) -> None:
    for name, t in (("xyz", xyz), ("new_xyz", new_xyz)):
        if t.dim() != 3 or t.shape[-1] != 3:
            raise ValueError(f"{op}: {name} must be [b, *, 3], got {tuple(t.shape)}")
    if xyz.shape[0] != new_xyz.shape[0]:
        raise ValueError(f"{op}: batch {xyz.shape[0]} != {new_xyz.shape[0]}")


def ball_query_withidx(radius: float, nsample: int, xyz: torch.Tensor,
                       new_xyz: torch.Tensor, sort_idx: torch.Tensor):
    """Ball query visiting the points in a caller-given order per query
    (the reference's attention grouping, tf_grouping_g.cu:260): sort_idx
    int [b, m, n]. Rank r counts where the point sort_idx[r] lies inside the
    radius; the first `nsample` such ranks are mapped back through sort_idx,
    padded by repeating the first (sort_idx[..., 0] for an empty ball).
    -> (idx int32 [b, m, nsample], cnt int32 [b, m])."""
    _check_query("ball_query_withidx", xyz, new_xyz)
    r2 = float(np.float32(radius * radius))
    order = sort_idx.long()
    parts = []
    for q0 in range(0, new_xyz.shape[1], _QUERY_CHUNK):
        d2 = _pairwise_dist2(new_xyz[:, q0:q0 + _QUERY_CHUNK], xyz)
        o = order[:, q0:q0 + _QUERY_CHUNK]
        rank, cnt = _first_k(d2.gather(-1, o) < r2, nsample)
        parts.append((o.gather(-1, rank.long()).to(torch.int32), cnt))
    return torch.cat([p[0] for p in parts], 1), torch.cat([p[1] for p in parts], 1)


def _order_key(s: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 whose signed order is the float order: the JAX
    package's order-preserving uint32 key minus 2^31 (the sign-flip
    transform; NaN-free inputs)."""
    bits = s.float().contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


# `ball_query_attention_plain` takes the queries in chunks: its live buffers
# are a few of [b, chunk, n] (the f32 feature distances, their int32 keys, the
# compacted keys and indices). A chunk holds at most ATTN_CHUNK_PAIRS pairs
# over max(b, ATTN_CHUNK_CLOUDS) clouds (1 GiB of 4-byte values each); SA1 of
# the flagship (4,096 queries over 16,384 points a cloud) runs in two chunks a
# radius at batch 8 and below. K9 holds no such buffer: it computes the keys
# of each ball's members only, so the card takes a whole radius in one call.
ATTN_CHUNK_PAIRS = 1 << 28
ATTN_CHUNK_CLOUDS = 8
_INT32_MIN = -(1 << 31)
# Tests only: K9's tiers. A ball of up to _ATTN_TILE_CAP members (at most
# 128) is resolved by its query tile; a larger one goes to the ball list,
# which keeps up to _ATTN_SMEM_CAP members (at most 4,096) in shared memory
# and streams a larger ball's cloud again in every pass. Tests lower them to
# reach every tier with small balls; the package never sets them.
_ATTN_TILE_CAP = 128
_ATTN_SMEM_CAP = 4096


def attention_chunk(b, m: int, n: int) -> int:
    """Queries a cloud of `ball_query_attention_plain`'s chunks: as many as
    keep max(b, ATTN_CHUNK_CLOUDS) x chunk x n within ATTN_CHUNK_PAIRS, at
    least 1, at most m. A symbolic b (a `torch.SymInt`) counts as
    ATTN_CHUNK_CLOUDS clouds."""
    clouds = b if isinstance(b, int) and b > ATTN_CHUNK_CLOUDS else ATTN_CHUNK_CLOUDS
    return max(1, min(m, ATTN_CHUNK_PAIRS // max(1, clouds * n)))


def attention_keys(new_feats: torch.Tensor, feats: torch.Tensor, a_sq: torch.Tensor,
                   b_sq: torch.Tensor) -> torch.Tensor:
    """The attention order keys, K9's arithmetic: int32 [b, q, n], the signed
    order key of (a_sq + b_sq) - 2 * cross, cross the f32 dot of the feature
    rows new_feats [b, q, cf] and feats [b, n, cf] summed in channel order
    from 0 (bf16 widened exactly), each operation rounded; a_sq [b, q] and
    b_sq [b, n] the squared norms. At cf = 1 this is
    `_order_key(square_distance(new_feats, feats))` bit for bit."""
    nf, f = new_feats.float(), feats.float()
    cross = torch.zeros(nf.shape[0], nf.shape[1], f.shape[1], device=nf.device)
    for c in range(nf.shape[-1]):
        cross = cross + nf[..., c, None] * f[:, None, :, c]
    return _order_key((a_sq[..., None] + b_sq[:, None, :]) - 2.0 * cross)


def _attention_select(xyz: torch.Tensor, new_xyz: torch.Tensor, key: torch.Tensor, r2: float,
                      ns: int):
    """The attention query over given keys int32 [b, q, n] (larger is
    visited first). Each row's in-radius points are compacted first, in
    index order (a running count and a scatter, no sort), to the widest
    row's count k, one host read: the bisection's 32 passes and the
    selections then run over [b, q, k], not [b, q, n]. -> (idx int32
    [b, q, ns], cnt int32 [b, q])."""
    b, q, n = new_xyz.shape[0], new_xyz.shape[1], xyz.shape[1]
    dev = new_xyz.device
    in_r = _pairwise_dist2(new_xyz, xyz) < r2  # [b, q, n]
    total = in_r.sum(-1)  # [b, q]
    k = max(int(total.max()), 1)
    slot = torch.where(in_r, in_r.cumsum(-1) - 1, k)  # out-of-radius: a spare slot
    ckey = torch.full((b, q, k + 1), _INT32_MIN, dtype=torch.int32, device=dev)
    ckey = ckey.scatter_(-1, slot, key)[..., :k]
    cidx = torch.zeros(b, q, k + 1, dtype=torch.int64, device=dev)
    cidx = cidx.scatter_(-1, slot, torch.arange(n, device=dev).expand(b, q, n))[..., :k]
    valid = torch.arange(k, device=dev) < total[..., None]
    ckey = torch.where(valid, ckey, _INT32_MIN)  # the spare slot's writes dropped
    # the largest unsigned threshold T with count(in-radius keys >= T) >= ns,
    # one bit a step from the top; a candidate has a bit set, so it is at
    # least 1 unsigned and the masked-out INT32_MIN never reaches it
    t = torch.zeros((b, q), dtype=torch.int64, device=dev)
    for bit in range(31, -1, -1):
        cand = t | (1 << bit)
        c = (ckey >= (cand - (1 << 31)).to(torch.int32)[..., None]).sum(-1)
        t = torch.where(c >= ns, cand, t)
    t = (t - (1 << 31)).to(torch.int32)[..., None]
    above = valid & (ckey > t)
    pos_gt, _ = _first_k(above, ns)
    pos_eq, _ = _first_k(valid & (ckey == t), ns)
    cg = above.sum(-1, dtype=torch.int32)[..., None]
    cnt = total.to(torch.int32).clamp(max=ns)
    slots = torch.arange(ns, device=dev, dtype=torch.int32)
    from_eq = (slots - cg).clamp(0, ns - 1).long()
    pos = torch.where(slots < cg, pos_gt, pos_eq.gather(-1, from_eq)).long()
    idx = cidx.gather(-1, pos.clamp(max=k - 1)).to(torch.int32)
    # pad rule: repeat the first-visited member, the max key (lowest index
    # on ties), so the multiset is the sorted visitation's
    kmax = ckey.amax(-1, keepdim=True)
    first_pos = torch.where(valid & (ckey == kmax), torch.arange(k, device=dev), k)
    first = cidx.gather(-1, first_pos.amin(-1, keepdim=True).clamp(max=k - 1)).to(torch.int32)
    idx = torch.where(slots < cnt[..., None], idx, first)
    idx = torch.where(cnt[..., None] > 0, idx, torch.zeros_like(idx))
    return idx, cnt


def ball_query_attention_plain(xyz: torch.Tensor, new_xyz: torch.Tensor, feats: torch.Tensor,
                               new_feats: torch.Tensor, a_sq: torch.Tensor, b_sq: torch.Tensor,
                               r2: float, ns: int):
    """K9's plain version: queries new_xyz [b, q, 3] over xyz [b, n, 3], in
    chunks of `attention_chunk` queries: each chunk's keys
    (`attention_keys`, [b, chunk, n]), then its compaction, bisection and
    selection (`_attention_select`). -> (idx int32 [b, q, ns], cnt int32
    [b, q])."""
    b, q, n = new_xyz.shape[0], new_xyz.shape[1], xyz.shape[1]
    chunk = attention_chunk(b, q, n)
    parts = []
    for q0 in range(0, q, chunk):
        key = attention_keys(new_feats[:, q0:q0 + chunk], feats, a_sq[:, q0:q0 + chunk], b_sq)
        parts.append(_attention_select(xyz, new_xyz[:, q0:q0 + chunk], key, r2, ns))
    if len(parts) == 1:
        return parts[0]
    return torch.cat([p[0] for p in parts], 1), torch.cat([p[1] for p in parts], 1)


@_build.on_input_device
def _ball_query_attention_cuda(xyz: torch.Tensor, new_xyz: torch.Tensor, feats: torch.Tensor,
                               new_feats: torch.Tensor, a_sq: torch.Tensor, b_sq: torch.Tensor,
                               r2: float, ns: int):
    """K9 (`csrc/ball_query_attention.cu`): query tiles, then the list of
    balls past the tile's cap, fixed-shape, no host read, no [b, q, n]
    buffer -> (idx int32 [b, q, ns], cnt int32 [b, q])."""
    b, n, _ = xyz.shape
    q, cf = new_xyz.shape[1], feats.shape[-1]
    if (xyz.dtype != torch.float32 or new_xyz.dtype != torch.float32
            or a_sq.dtype != torch.float32 or b_sq.dtype != torch.float32
            or feats.dtype not in (torch.float32, torch.bfloat16)
            or new_feats.dtype != feats.dtype):
        raise ValueError(f"ball_query_attention: kernel takes f32 points and norms and f32 or "
                         f"bf16 features, got {xyz.dtype}, {new_xyz.dtype}, {feats.dtype}, "
                         f"{new_feats.dtype}, {a_sq.dtype}, {b_sq.dtype}")
    if (feats.shape != (b, n, cf) or new_feats.shape != (b, q, cf) or a_sq.shape != (b, q)
            or b_sq.shape != (b, n)):
        raise ValueError(f"ball_query_attention: feats {tuple(feats.shape)}, new_feats "
                         f"{tuple(new_feats.shape)}, a_sq {tuple(a_sq.shape)}, b_sq "
                         f"{tuple(b_sq.shape)} do not fit xyz {tuple(xyz.shape)} and new_xyz "
                         f"{tuple(new_xyz.shape)}")
    if not n:  # an empty cloud leaves every ball empty: all 0
        return (torch.zeros(b, q, ns, dtype=torch.int32, device=xyz.device),
                torch.zeros(b, q, dtype=torch.int32, device=xyz.device))
    idx = torch.empty(b, q, ns, dtype=torch.int32, device=xyz.device)
    cnt = torch.empty(b, q, dtype=torch.int32, device=xyz.device)
    listed = torch.empty(1 + b * q, dtype=torch.int32, device=xyz.device)
    if b * q:
        args = [t.contiguous() for t in (xyz, new_xyz, feats, new_feats, a_sq, b_sq)]
        _build.BALL_QUERY_ATTENTION(*(t.data_ptr() for t in args), idx.data_ptr(),
                                    cnt.data_ptr(), listed.data_ptr(), b, n, q, cf,
                                    int(feats.dtype == torch.bfloat16), r2, ns, _ATTN_TILE_CAP,
                                    _ATTN_SMEM_CAP)
    return idx, cnt


def ball_query_attention(radius: float, nsample: int, xyz: torch.Tensor,
                         new_xyz: torch.Tensor, feats: torch.Tensor,
                         new_feats: torch.Tensor):
    """Attention-ordered ball query without a per-query sort.

    The reference visits the n points of each query in descending feature
    distance (`square_distance` of new_feats [b, m, cf] against feats
    [b, n, cf]) and takes the first `nsample` inside the radius
    (layers_util.py:122-130, tf_grouping_g.cu:260). This computes the same
    emitted multiset as the JAX package does: the in-radius points with
    the largest feature distance, a threshold tie going to the lowest
    index (the stable sort's rule), padded by repeating the first-visited
    member (the largest key, lowest index on ties); slots are in index
    order. The threshold comes from a 32-step bisection over
    order-preserving integer keys of each ball's points. The squared norms
    are summed here as `square_distance` sums them (in the features' dtype,
    then f32), once a query; the rest is the custom op
    `torch.ops.ssd3d.ball_query_attention`, one call a radius: K9 on the
    card (the keys of each ball's members only, no host read, so attention
    configs export), `ball_query_attention_plain` on the CPU.
    -> (idx int32 [b, m, nsample], cnt int32 [b, m]); equal to the JAX
    package's at f32."""
    _check_query("ball_query_attention", xyz, new_xyz)
    _build.require_cuda("ball_query_attention", xyz, new_xyz, feats, new_feats)
    r2 = float(np.float32(radius * radius))
    feats, new_feats = feats.detach(), new_feats.detach()  # the outputs are indices
    a_sq = (new_feats * new_feats).sum(-1).float()
    b_sq = (feats * feats).sum(-1).float()
    return torch.ops.ssd3d.ball_query_attention(xyz, new_xyz, feats, new_feats, a_sq, b_sq, r2,
                                                nsample)


def knn_points(k: int, xyz: torch.Tensor, new_xyz: torch.Tensor):
    """The k nearest points of each query (reference knn_point,
    tf_grouping.py:130): the top k of the negated squared distance ->
    (dist2 f32 [b, m, k] ascending, idx int32 [b, m, k])."""
    _check_query("knn_points", xyz, new_xyz)
    parts = []
    for q0 in range(0, new_xyz.shape[1], _QUERY_CHUNK):
        neg, idx = (-_pairwise_dist2(new_xyz[:, q0:q0 + _QUERY_CHUNK], xyz)).topk(k, dim=-1)
        parts.append((-neg, idx.to(torch.int32)))
    return torch.cat([p[0] for p in parts], 1), torch.cat([p[1] for p in parts], 1)


def _points_in_boxes(xyz: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """xyz: [b, n, 3]; boxes: [b, m, 7] -> bool [b, m, n]. A point is inside
    when, in the box's frame, |x| <= l/2, -h <= y <= 0 and |z| <= w/2 (the
    reference CUDA test, tf_grouping_g.cu:27)."""
    b, n, _ = xyz.shape
    m = boxes.shape[1]
    canon = canonicalize_points(xyz[:, None].expand(b, m, n, 3), boxes)  # [b, m, n, 3]
    l, h, w = boxes[..., 3:4], boxes[..., 4:5], boxes[..., 5:6]
    return ((canon[..., 0].abs() <= l / 2.0) & (canon[..., 2].abs() <= w / 2.0)
            & (canon[..., 1] <= 0.0) & (canon[..., 1] >= -h))


def query_boxes_3d_points(xyz: torch.Tensor, boxes: torch.Tensor, nsample: int):
    """First `nsample` interior points per rotated box (the reference CUDA
    op's contract, tf_grouping_g.cu:46). xyz: [b, n, 3]; boxes: [b, m, 7]
    -> (idx int32 [b, m, nsample], cnt int32 [b, m])."""
    return _first_k(_points_in_boxes(xyz, boxes), nsample)


def query_boxes_3d_mask(xyz: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Interior mask of rotated boxes (tf_grouping_g.cu:100). xyz: [b, n, 3];
    boxes: [b, m, 7] -> int32 [b, m, n]."""
    return _points_in_boxes(xyz, boxes).to(torch.int32)


def query_points_iou(xyz: torch.Tensor, anchors: torch.Tensor, gt_boxes: torch.Tensor,
                     iou_3d: torch.Tensor) -> torch.Tensor:
    """The point-membership IoU of each anchor with each GT box: the points
    inside both over the points inside either (at least 1), where their 3D
    IoU is at least 1e-3, else 0 (the reference CUDA op,
    tf_grouping_g.cu:139). xyz: [b, n, 3]; anchors: [b, a, 7]; gt_boxes:
    [b, g, 7]; iou_3d: [b, a, g] -> [b, a, g]."""
    in_a = _points_in_boxes(xyz, anchors).float()  # [b, a, n]
    in_g = _points_in_boxes(xyz, gt_boxes).float()  # [b, g, n]
    inter = torch.einsum("ban,bgn->bag", in_a, in_g)  # counts, exact in f32
    union = (in_a.sum(-1)[:, :, None] + in_g.sum(-1)[:, None, :] - inter).clamp(min=1.0)
    return torch.where(iou_3d >= 1e-3, inter / union, 0.0)


def gather_rows_plain(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points: [b, n, c], idx: int [b, rows] -> [b, rows, c]; indices clamp
    into [0, n) as in the kernel."""
    n, c = points.shape[1], points.shape[2]
    flat = idx.long().clamp(0, n - 1)
    return points.gather(1, flat[..., None].expand(-1, -1, c))


@_build.on_input_device
def _gather_rows_cuda(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if points.dtype not in (torch.float32, torch.int32):
        raise ValueError(f"group_points: kernel takes f32 or i32, got {points.dtype}")
    b, n, c = points.shape
    rows = idx.shape[1]
    points = points.contiguous()
    idx = idx.to(torch.int32).contiguous()
    out = torch.empty(b, rows, c, dtype=points.dtype, device=points.device)
    if out.numel():  # nothing to launch for zero rows
        _build.GATHER(points.data_ptr(), idx.data_ptr(), out.data_ptr(), b, n, rows, c)
    return out


def _gather_rows(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    _build.require_cuda("gather_rows", points, idx)
    return torch.ops.ssd3d.gather_rows(points, idx)


def scatter_add_rows_plain(idx: torch.Tensor, g: torch.Tensor, n: int) -> torch.Tensor:
    """idx: int [b, rows], g: [b, rows, c] -> dsrc [b, n, c] with
    dsrc[b, clamp(idx[b, r], 0, n - 1)] += g[b, r]; duplicates accumulate.
    On the CPU index_add_ adds each destination's rows in ascending row
    order, the order kernel K5 keeps."""
    b, rows, c = g.shape
    flat = idx.long().clamp(0, n - 1) + n * torch.arange(b, device=idx.device)[:, None]
    out = torch.zeros(b * n, c, dtype=g.dtype, device=g.device)
    return out.index_add_(0, flat.reshape(-1), g.reshape(b * rows, c)).reshape(b, n, c)


@_build.on_input_device
def _scatter_add_rows_cuda(idx: torch.Tensor, g: torch.Tensor, n: int) -> torch.Tensor:
    if g.dtype != torch.float32:
        raise ValueError(f"scatter_add_rows: kernel takes f32, got {g.dtype}")
    b, rows, c = g.shape
    g = g.contiguous()
    idx = idx.to(torch.int32).contiguous()
    out = torch.empty(b, n, c, dtype=g.dtype, device=g.device)  # written whole by the kernel
    # the kernel's CSR: counts, then cursors [b, n]; offsets [b, n + 1]; rows by destination
    scratch = torch.empty(b * n + b * (n + 1) + b * rows, dtype=torch.int32, device=g.device)
    cnt, offs, order = scratch.split([b * n, b * (n + 1), b * rows])
    _build.SCATTER_ADD(idx.data_ptr(), g.data_ptr(), out.data_ptr(), cnt.data_ptr(),
                       offs.data_ptr(), order.data_ptr(), b, n, rows, c)
    return out


def scatter_add_rows(idx: torch.Tensor, g: torch.Tensor, n: int) -> torch.Tensor:
    """Row scatter-add, the gather's backward: idx int [b, rows], g [b, rows,
    c] -> [b, n, c]. Each destination sums its rows in ascending row order on
    either device, so the kernel equals the CPU plain version bit for bit."""
    if g.dim() != 3 or idx.shape != g.shape[:2]:
        raise ValueError(f"scatter_add_rows: idx {tuple(idx.shape)}, g {tuple(g.shape)}")
    _build.require_cuda("scatter_add_rows", idx, g)
    return torch.ops.ssd3d.scatter_add_rows(idx, g, n)


class _GatherRows(torch.autograd.Function):
    """The row gather with the row scatter-add as its backward (the CUDA
    GroupPointGrad contract); both are custom ops (`ops/library.py`) and
    dispatch on the device."""

    @staticmethod
    def forward(ctx, points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(idx)
        ctx.n = points.shape[1]
        return _gather_rows(points, idx)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (idx,) = ctx.saved_tensors
        return scatter_add_rows(idx, g, ctx.n), None


def gather_rows(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather: points [b, n, c], idx int [b, rows] -> [b, rows, c].
    Differentiable wrt points (backward: `scatter_add_rows`)."""
    if points.dim() != 3 or idx.dim() != 2 or idx.shape[0] != points.shape[0]:
        raise ValueError(f"gather_rows: points {tuple(points.shape)}, idx {tuple(idx.shape)}")
    if points.requires_grad and torch.is_grad_enabled():
        return _GatherRows.apply(points, idx)
    return _gather_rows(points, idx)


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points: [b, n, c], idx: int [b, m, s] -> [b, m, s, c]."""
    b, m, s = idx.shape
    out = gather_rows(points, idx.reshape(b, m * s))
    return out.reshape(b, m, s, points.shape[-1])
