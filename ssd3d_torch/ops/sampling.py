"""Point sampling: D-FPS, F-FPS, the row gather of sampled points and the
first-k gather by mask.

Counterpart of `ssd3d/ops/sampling.py`. The three FPS functions dispatch on
the device of their input: a CUDA tensor launches the hand-written kernel
(`csrc/fps.cu`, `csrc/ffps.cu`, each with three routes chosen from the
shape, which together take any n and c; `csrc/ffps_dist.cu` over a given
distance matrix, any n), a CPU tensor takes the plain PyTorch version
beside it. `farthest_point_sample_with_preidx` and `prob_sample` are plain
PyTorch on every device, as the JAX package has no kernel for them. Both follow the JAX
package's contract: pick 0 is index 0, the running minimum of squared
distance decides the next pick, argmax ties go to the lowest index.

Squared distances are written in a fixed order of rounded operations, so
the kernel and its plain version agree bit for bit: for xyz the chain
fma(dz, dz, fma(dy, dy, dx*dx)) (`xyz_dist2`), which is what the JAX
package's CPU path computes (XLA contracts its sum of squares into fused
multiply-adds; on a lattice of voxel centres, where distances tie, any other
rounding picks other points), and for fused vectors a channel-ordered
running sum of separately rounded terms. The kernels are compiled without
FMA contraction and call the FMA explicitly where the chain has one.
"""

from __future__ import annotations

import torch

from ssd3d_torch.ops import _build


def _check_points(op: str, x: torch.Tensor, c: int | None = None) -> None:
    if x.dim() != 3 or (c is not None and x.shape[-1] != c):
        raise ValueError(f"{op}: expected [b, n, {c or 'c'}], got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise ValueError(f"{op}: expected float32, got {x.dtype}")


# ---------------------------------------------------------------- D-FPS (K1)

def xyz_dist2(dx: torch.Tensor, dy: torch.Tensor, dz: torch.Tensor) -> torch.Tensor:
    """Squared distances from f32 coordinate differences as fma(dz, dz,
    fma(dy, dy, dx * dx)), each fused multiply-add rounded once to f32 (K1's
    `__fmaf_rn`). A product of two f32 is exact in float64, so each step is
    its float64 sum rounded to f32, which is the one rounding of the fused
    operation unless the float64 sum falls exactly on an f32 halfway point
    after rounding away nonzero bits (about 2^-28 of random inputs)."""
    t = (dx * dx).double()
    t = (dy.double() * dy.double() + t).float().double()
    return (dz.double() * dz.double() + t).float()


def fps_plain(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Plain D-FPS. xyz: f32 [b, n, 3] -> int32 [b, npoint]."""
    b, n, _ = xyz.shape
    x, y, z = xyz.unbind(-1)
    out = torch.zeros(b, npoint, dtype=torch.int64, device=xyz.device)
    dist = torch.full((b, n), float("inf"), dtype=xyz.dtype, device=xyz.device)
    last = torch.zeros(b, 1, dtype=torch.int64, device=xyz.device)
    for i in range(1, npoint):
        dx = x - x.gather(1, last)
        dy = y - y.gather(1, last)
        dz = z - z.gather(1, last)
        dist = torch.minimum(dist, xyz_dist2(dx, dy, dz))
        last = dist.argmax(dim=1, keepdim=True)
        out[:, i] = last[:, 0]
    return out.to(torch.int32)


# K1 has three routes (csrc/fps.cu): one cloud over a thread-block cluster of
# up to 16 SMs, or one block a cloud, both holding the whole cloud in shared
# memory (so n <= 16,384); and the slice route for larger clouds, a cluster
# a cloud whose CTAs hold only their slices. At every D-FPS shape of the
# three paths with at most 16 clouds (256 to 16,384 points) the cluster
# route was faster; at the RCNN's 400 clouds the one-block route was
# (chip_smoke.py phase 2; PERF.md §6).
FPS_CLUSTER_MAX_CLOUDS = 16
FPS_MAX_POINTS = 16384  # the cluster and one-block routes hold the cloud in shared memory


def fps_route(b: int, n: int) -> str:
    """K1's route for b clouds of n points: "cluster", "block" or "slice"."""
    if n > FPS_MAX_POINTS:
        return "slice"
    return "cluster" if b <= FPS_CLUSTER_MAX_CLOUDS else "block"


# The slice route's plan mirrors the kernel's `slice_plan` (csrc/fps.cu): a
# CTA takes ceil(n / size) points. Up to 8,192 (the register tier) it keeps
# xyz and the running distance of each in registers, the cluster route's
# shape (8 points a thread up to 512 threads, then up to 16); up to 16,384
# (the shared tier) xyz in shared memory, 12 bytes a point, and 16
# distances a thread of 1,024 in registers; past that (the global tier) it
# reads xyz from the input at every pick and keeps the distances in a
# scratch buffer of b x n floats. Every CTA asks for at least 120 KB of
# shared memory, so that one takes an SM.
DFPS_CTA_THREADS = 512
DFPS_SLICE_THREADS = 1024
DFPS_TARGET_PPT = 8
DFPS_REG_SLICE = DFPS_CTA_THREADS * 16
DFPS_SHARED_SLICE = DFPS_SLICE_THREADS * 16
DFPS_SPREAD_SMEM = 120 * 1024
# cluster sizes of the slice route, largest first; 1 is one block a cloud
DFPS_SLICE_SIZES = (16, 8, 4, 2, 1)
# the tiers, fastest first: a pick took ~1, ~3.5 and ~10 us a wave on them
# at [32, 32768] -> 1024 (chip_smoke.py phase 2; PERF.md §6)
DFPS_TIERS = ("registers", "shared", "global")


def dfps_slice_plan(n: int, size: int) -> dict:
    """The slice route's CTA for clouds of n points over `size` CTAs: its
    tier ("registers", "shared" or "global"), points a CTA, threads, points
    a thread (0 on the global tier) and dynamic shared memory."""
    slice_ = -(-n // size)
    if slice_ <= DFPS_REG_SLICE:
        want = -(-slice_ // DFPS_TARGET_PPT)
        threads = min(DFPS_CTA_THREADS, max(32, -(-want // 32) * 32))
        ppt = 1
        while threads * ppt < slice_:
            ppt *= 2
        return dict(tier="registers", slice=slice_, threads=threads, ppt=ppt,
                    smem=DFPS_SPREAD_SMEM)
    if slice_ <= DFPS_SHARED_SLICE:
        return dict(tier="shared", slice=slice_, threads=DFPS_SLICE_THREADS, ppt=16,
                    smem=max(12 * slice_, DFPS_SPREAD_SMEM))
    return dict(tier="global", slice=slice_, threads=DFPS_SLICE_THREADS, ppt=0,
                smem=DFPS_SPREAD_SMEM)


def dfps_slice_size(b: int, n: int) -> int:
    """The slice route's cluster size for b clouds of n points: the size on
    the fastest tier, then with the fewest waves of clusters (b over how
    many are resident at once on this card: an occupancy query, nothing
    launched), then the largest. At [32, 32768] clusters of 4 in two waves
    beat clusters of 2, all resident, on the shared tier, and one block a
    cloud reading its points from global memory."""
    def cost(size: int) -> tuple:
        waves = -(-b // max(1, _build.dfps_slice_clusters(n, size)))
        return DFPS_TIERS.index(dfps_slice_plan(n, size)["tier"]), waves, -size

    return min(DFPS_SLICE_SIZES, key=cost)


@_build.on_input_device
def _fps_cuda(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """K1 on the route `fps_route` picks (tests and timing patch it, or
    `dfps_slice_size`, to force one)."""
    b, n, _ = xyz.shape
    route = fps_route(b, n)
    codes = {"block": 0, "cluster": 1, "slice": 2}
    if route not in codes:
        raise ValueError(f"farthest_point_sample: unknown route {route!r}")
    if route != "slice" and n > FPS_MAX_POINTS:
        raise ValueError(f"farthest_point_sample: the {route} route holds the cloud in shared "
                         f"memory and takes n <= {FPS_MAX_POINTS}, got {n}")
    xyz = xyz.contiguous()
    out = torch.empty(b, npoint, dtype=torch.int32, device=xyz.device)
    size, scratch = 0, None
    if route == "slice":
        size = dfps_slice_size(b, n)
        if dfps_slice_plan(n, size)["tier"] == "global":
            scratch = torch.empty(b, n, dtype=torch.float32, device=xyz.device)
    _build.FPS(xyz.data_ptr(), out.data_ptr(), scratch.data_ptr() if scratch is not None else None,
               b, n, npoint, codes[route], size, route=route)
    return out


def farthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """D-FPS. xyz: f32 [b, n, 3] -> int32 [b, npoint]."""
    _check_points("farthest_point_sample", xyz, 3)
    if _build.require_cuda("farthest_point_sample", xyz):
        return _fps_cuda(xyz, npoint)
    return fps_plain(xyz, npoint)


# ---------------------------------------------------------------- F-FPS (K2)

def fused_square_distance(fused: torch.Tensor) -> torch.Tensor:
    """[b, n, c] -> [b, n, n] squared distances, channels summed in order
    from exact differences (the arithmetic of the F-FPS kernel)."""
    b, n, c = fused.shape
    acc = torch.zeros(b, n, n, dtype=fused.dtype, device=fused.device)
    for ch in range(c):
        f = fused[..., ch]
        diff = f[:, :, None] - f[:, None, :]
        acc = acc + diff * diff
    return acc


def fps_from_dist_plain(dist: torch.Tensor, npoint: int) -> torch.Tensor:
    """Plain F-FPS over a given distance matrix: dist [b, n, n] (any float
    dtype) -> int32 [b, npoint]. Each step takes the row of the last pick,
    as given (the matrix need not be symmetric)."""
    b, n, _ = dist.shape
    out = torch.zeros(b, npoint, dtype=torch.int64, device=dist.device)
    min_dist = torch.full((b, n), float("inf"), dtype=dist.dtype, device=dist.device)
    last = torch.zeros(b, 1, 1, dtype=torch.int64, device=dist.device)
    for i in range(1, npoint):
        row = dist.gather(1, last.expand(b, 1, n))[:, 0]
        min_dist = torch.minimum(min_dist, row)
        nxt = min_dist.argmax(dim=1)
        out[:, i] = nxt
        last = nxt[:, None, None]
    return out.to(torch.int32)


# K2m (csrc/ffps_dist.cu): one block of 1,024 threads a cloud, each thread
# keeping the running minima of its points t + k * 1024 in registers (up to
# 16 a thread, n <= 16,384), past that in a scratch buffer [b, n].
FFPS_DIST_THREADS = 1024
FFPS_DIST_MAX_PPT = 16


def ffps_dist_ppt(n: int) -> int:
    """K2m's running minima a thread for clouds of n points: the least power
    of two that covers n over 1,024 threads, or 0 (the scratch buffer) past
    16."""
    ppt = 1
    while ppt * FFPS_DIST_THREADS < n:
        ppt *= 2
    return ppt if ppt <= FFPS_DIST_MAX_PPT else 0


@_build.on_input_device
def _ffps_dist_cuda(dist: torch.Tensor, npoint: int) -> torch.Tensor:
    if dist.dtype != torch.float32:
        raise ValueError(f"farthest_point_sample_from_dist: the kernel takes float32, "
                         f"got {dist.dtype}")
    b, n, _ = dist.shape
    dist = dist.contiguous()
    out = torch.empty(b, npoint, dtype=torch.int32, device=dist.device)
    if out.numel() == 0:
        return out
    ppt = ffps_dist_ppt(n)
    scratch = None if ppt else torch.empty(b, n, dtype=torch.float32, device=dist.device)
    _build.FFPS_DIST(dist.data_ptr(), out.data_ptr(),
                     scratch.data_ptr() if scratch is not None else None, b, n, npoint, ppt)
    return out


def farthest_point_sample_from_dist(dist: torch.Tensor, npoint: int) -> torch.Tensor:
    """F-FPS over a given squared-distance matrix: dist [b, n, n] -> int32
    [b, npoint]. Pick 0 is index 0; each point keeps the running minimum of
    the picked points' rows; the next pick is the argmax, ties to the lowest
    index. A CUDA tensor launches K2m and must be float32, as the TPU's
    kernels take; a CPU tensor of any float dtype takes the plain loop."""
    if dist.dim() != 3 or dist.shape[1] != dist.shape[2]:
        raise ValueError(f"farthest_point_sample_from_dist: expected [b, n, n], "
                         f"got {tuple(dist.shape)}")
    dist = dist.detach()
    if _build.require_cuda("farthest_point_sample_from_dist", dist):
        return _ffps_dist_cuda(dist, npoint)
    return fps_from_dist_plain(dist, npoint)


def ffps_plain(fused: torch.Tensor, npoint: int) -> torch.Tensor:
    """Plain F-FPS. fused: f32 [b, n, c] -> int32 [b, npoint]. Each step
    computes the last pick's row of squared distances only, channels summed
    in order from exact differences: bit for bit the row of
    `fused_square_distance`, without its [b, n, n] matrix."""
    b, n, c = fused.shape
    out = torch.zeros(b, npoint, dtype=torch.int64, device=fused.device)
    min_dist = torch.full((b, n), float("inf"), dtype=fused.dtype, device=fused.device)
    last = torch.zeros(b, 1, 1, dtype=torch.int64, device=fused.device)
    for i in range(1, npoint):
        pick = fused.gather(1, last.expand(b, 1, c))  # [b, 1, c]
        row = torch.zeros(b, n, dtype=fused.dtype, device=fused.device)
        for ch in range(c):
            diff = fused[..., ch] - pick[..., ch]
            row = row + diff * diff
        min_dist = torch.minimum(min_dist, row)
        nxt = min_dist.argmax(dim=1)
        out[:, i] = nxt
        last = nxt[:, None, None]
    return out.to(torch.int32)


# K2 has three routes (csrc/ffps.cu): one cloud over a thread-block cluster,
# each CTA holding its slice of the points in shared memory; one block a
# cloud (n <= 8,192, c <= 4,096); and the stream route, a cluster of 16 a
# cloud re-reading its points from global memory at every pick, for any n
# and c. The cluster route's plan mirrors the kernel's `plan`: a CTA takes
# ceil(n / size) points, a thread each up to 512 threads; rows of c floats
# rounded up to an odd number of 16-byte vectors; shared memory for its
# slice's rows, one row a warp (the winner's) and a distance a point, at
# least 120 KB so that one CTA takes an SM, and 4,112 bytes of keys and
# barriers on top. A block may use 232,448 bytes (227 KB) of shared memory.
FFPS_CLUSTER_SIZES = (16, 8, 4, 2)
FFPS_CTA_THREADS = 512
FFPS_SPREAD_SMEM = 120 * 1024
FFPS_STATIC_SMEM = 8 * (2 * 16 * FFPS_CTA_THREADS // 32 + 2)
FFPS_BLOCK_SMEM = 232_448
FFPS_BLOCK_MAX_POINTS = 8192
FFPS_BLOCK_MAX_CHANNELS = 4096
# the stream route: clusters of 16 CTAs of 1,024 threads, up to 8 points a
# thread with their distances in registers, else in a scratch buffer
FFPS_STREAM_CLUSTER = 16
FFPS_STREAM_THREADS = 1024
FFPS_STREAM_MAX_PPT = 8


def ffps_row_stride(c: int) -> int:
    """Floats a row of the cluster route's slice: c rounded up to 16-byte
    vectors, an odd number of them (no bank conflict between 8 rows)."""
    vec = (c + 3) // 4
    return 4 * (vec + 1 if vec % 2 == 0 else vec)


def ffps_cluster_plan(n: int, c: int, size: int) -> dict:
    """The cluster route's CTA for n points of c channels over `size` CTAs:
    points a CTA, threads, row stride (floats) and dynamic shared memory."""
    slice_ = -(-n // size)
    threads = min(FFPS_CTA_THREADS, -(-slice_ // 32) * 32)
    stride = ffps_row_stride(c)
    need = 4 * (slice_ * stride + (threads // 32) * stride + slice_)
    return dict(slice=slice_, threads=threads, stride=stride, smem=max(need, FFPS_SPREAD_SMEM))


def ffps_cluster_fits(n: int, c: int, size: int) -> bool:
    """Whether a slice of an n x c cloud over `size` CTAs fits in a block's
    shared memory."""
    return ffps_cluster_plan(n, c, size)["smem"] + FFPS_STATIC_SMEM <= FFPS_BLOCK_SMEM


def ffps_stream_plan(n: int) -> dict:
    """The stream route's CTA for clouds of n points (the kernel's
    `stream_ppt`): points a CTA and points a thread, 0 where the distances
    go to the scratch buffer (past 8 a thread)."""
    slice_ = -(-n // FFPS_STREAM_CLUSTER)
    ppt = 1
    while ppt * FFPS_STREAM_THREADS < slice_ and ppt < FFPS_STREAM_MAX_PPT:
        ppt *= 2
    return dict(slice=slice_, ppt=ppt if ppt * FFPS_STREAM_THREADS >= slice_ else 0)


def ffps_block_fits(n: int, c: int) -> bool:
    """Whether the one-block route takes an n x c cloud."""
    return n <= FFPS_BLOCK_MAX_POINTS and c <= FFPS_BLOCK_MAX_CHANNELS


def ffps_cluster_size(b: int, n: int, c: int) -> int:
    """K2's cluster size for b clouds of n x c: the largest of 16, 8, 4 and 2
    whose slice fits in shared memory and at which all b clusters are
    resident at once on this card (an occupancy query, nothing launched);
    0 where none is."""
    for size in FFPS_CLUSTER_SIZES:
        if ffps_cluster_fits(n, c, size) and _build.ffps_max_clusters(n, c, size) >= b:
            return size
    return 0


def ffps_route(b: int, n: int, c: int) -> str:
    """K2's route for b clouds of n x c: "cluster" where a cluster size fits
    (`ffps_cluster_size`), else "block" where the one-block route takes the
    shape, else "stream"."""
    if ffps_cluster_size(b, n, c):
        return "cluster"
    return "block" if ffps_block_fits(n, c) else "stream"


@_build.on_input_device
def _ffps_cuda(fused: torch.Tensor, npoint: int) -> torch.Tensor:
    """K2 on the route `ffps_route` picks (tests and timing patch it, or
    `ffps_cluster_size`, to force one)."""
    b, n, c = fused.shape
    route = ffps_route(b, n, c)
    out = torch.empty(b, npoint, dtype=torch.int32, device=fused.device)
    if route == "cluster":
        size = ffps_cluster_size(b, n, c)
        if not size:
            raise ValueError(f"farthest_point_sample_features: no cluster size fits "
                             f"{b} clouds of {n} x {c}")
        fused = fused.contiguous()  # [b, n, c]: each CTA loads its slice's rows
        _build.FFPS(fused.data_ptr(), out.data_ptr(), None, b, n, c, npoint, 1, size, route=route)
    elif route in ("block", "stream"):
        if route == "block" and not ffps_block_fits(n, c):
            raise ValueError(
                f"farthest_point_sample_features: the one-block route takes n <= "
                f"{FFPS_BLOCK_MAX_POINTS} and c <= {FFPS_BLOCK_MAX_CHANNELS}, got n={n}, c={c}")
        scratch = None
        if route == "stream" and ffps_stream_plan(n)["ppt"] == 0:
            scratch = torch.empty(b, n, dtype=torch.float32, device=fused.device)
        chan_major = fused.transpose(1, 2).contiguous()  # [b, c, n]: coalesced rows
        _build.FFPS(chan_major.data_ptr(), out.data_ptr(),
                    scratch.data_ptr() if scratch is not None else None, b, n, c, npoint,
                    0 if route == "block" else 2, 0, route=route)
    else:
        raise ValueError(f"farthest_point_sample_features: unknown route {route!r}")
    return out


def farthest_point_sample_features(fused: torch.Tensor, npoint: int) -> torch.Tensor:
    """F-FPS over fused (xyz ++ feature) vectors.
    fused: f32 [b, n, c] -> int32 [b, npoint]."""
    _check_points("farthest_point_sample_features", fused)
    if _build.require_cuda("farthest_point_sample_features", fused):
        return _ffps_cuda(fused, npoint)
    return ffps_plain(fused, npoint)


def fps_pick_shortfall(points: torch.Tensor, picks: torch.Tensor) -> float:
    """Tie-aware check of an FPS pick sequence over points [b, n, c].

    Runs the min-distance recurrence (float64, exact differences) along the
    given picks and returns the largest relative shortfall of a pick's
    distance below the maximum at its step: 0.0 when every pick is a
    farthest point. Two correct F-FPS implementations that round d2
    differently may part ways at a near-tie; both still score ~0 here."""
    p = points.double()
    idx = picks.long()
    b, n, c = p.shape
    min_d = torch.full((b, n), float("inf"), dtype=torch.float64, device=p.device)
    worst = torch.zeros((), dtype=torch.float64, device=p.device)
    for i in range(1, idx.shape[1]):
        last = p.gather(1, idx[:, i - 1, None, None].expand(b, 1, c))
        min_d = torch.minimum(min_d, ((p - last) ** 2).sum(-1))
        best = min_d.amax(1)
        got = min_d.gather(1, idx[:, i:i + 1])[:, 0]
        worst = torch.maximum(worst, ((best - got) / best.clamp(min=1e-30)).amax())
    return float(worst)


def farthest_point_sample_with_preidx(xyz: torch.Tensor, preidx: torch.Tensor,
                                      npoint: int) -> torch.Tensor:
    """D-FPS seeded by earlier picks: the running minimum starts as each
    point's least squared distance to the `preidx` points, and every one of
    the `npoint` picks is an argmax (ties to the lowest index), the first
    included. xyz: f32 [b, n, 3]; preidx: int [b, m1] -> int32 [b, npoint].
    Plain PyTorch on every device, as the JAX package has no kernel for it."""
    _check_points("farthest_point_sample_with_preidx", xyz, 3)
    b, n, _ = xyz.shape
    xyz = xyz.detach()
    seeds = gather_points(xyz, preidx)  # [b, m1, 3]
    min_dist = xyz_dist2(*(xyz[:, :, None, :] - seeds[:, None, :, :]).unbind(-1)).amin(-1)
    out = torch.zeros(b, npoint, dtype=torch.int64, device=xyz.device)
    for i in range(npoint):
        nxt = min_dist.argmax(dim=1)
        out[:, i] = nxt
        pick = xyz.gather(1, nxt[:, None, None].expand(b, 1, 3))
        min_dist = torch.minimum(min_dist, xyz_dist2(*(xyz - pick).unbind(-1)))
    return out.to(torch.int32)


def prob_sample(weights: torch.Tensor, num: int, gumbel: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """Categorical sampling by weight, with replacement: weights [b, n] ->
    int32 [b, num]. Each draw is the argmax of log(max(w, 1e-20)) plus
    Gumbel noise, which is how `jax.random.categorical` draws; `gumbel`
    [b, num, n] is that noise (a test hands in JAX's own), else it is drawn
    from `generator` on the weights' device. Plain PyTorch on every device."""
    b, n = weights.shape
    logits = torch.log(weights.clamp(min=1e-20))
    if gumbel is None:
        tiny = torch.finfo(weights.dtype).tiny
        u = torch.rand(b, num, n, generator=generator, device=weights.device,
                       dtype=weights.dtype).clamp(min=tiny)
        gumbel = -torch.log(-torch.log(u))
    return (logits[:, None, :] + gumbel).argmax(-1).to(torch.int32)


# ---------------------------------------------------------------- gathers

def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points: [b, n, c], idx: int [b, m] -> [b, m, c]."""
    return points.gather(1, idx.long()[..., None].expand(-1, -1, points.shape[-1]))


def gather_by_mask(points: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """The first `k` rows where mask is true, in index order, padded by
    repeating the first hit (row 0 where there is none). points: [b, n, c]
    (any dtype); mask: [b, n] (bool or 0/1) -> [b, k, c]. Cuts the RCNN's
    minibatch out of the proposals (reference sampler.py:41,
    tf_sampling_g.cu:351)."""
    b, n, _ = points.shape
    if k > n:
        raise ValueError(f"gather_by_mask: k {k} > n {n}")
    mask = mask.bool()
    iota = torch.arange(n, device=points.device)
    # mask-true rows first, each part in index order; the keys are distinct
    order = torch.where(mask, iota, n + iota).argsort(-1)[:, :k]
    cnt = mask.sum(-1, keepdim=True)
    sel = torch.where(torch.arange(k, device=points.device) < cnt, order, order[:, :1])
    return gather_points(points, sel)
