"""Point sampling: D-FPS, F-FPS and the row gather of sampled points.

Counterpart of `ssd3d/ops/sampling.py`. The two FPS functions dispatch on the
device of their input: a CUDA tensor launches the hand-written kernel
(`csrc/fps.cu`, `csrc/ffps.cu`), a CPU tensor takes the plain PyTorch version
beside it. Both follow the JAX package's contract: pick 0 is index 0, the
running minimum of squared distance decides the next pick, argmax ties go to
the lowest index.

Squared distances are written as separate rounded operations in a fixed
order, ((dx*dx + dy*dy) + dz*dz) for xyz and a channel-ordered running sum
for fused vectors, and the kernels are compiled without FMA contraction, so
the kernel and its plain version agree bit for bit.
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
        dist = torch.minimum(dist, (dx * dx + dy * dy) + dz * dz)
        last = dist.argmax(dim=1, keepdim=True)
        out[:, i] = last[:, 0]
    return out.to(torch.int32)


# K1 has two routes (csrc/fps.cu): one cloud over a thread-block cluster of up
# to 16 SMs, or one block a cloud. At every D-FPS shape of the three paths
# with at most 16 clouds (256 to 16,384 points) the cluster route was faster;
# at the RCNN's 400 clouds the one-block route was (chip_smoke.py phase 2;
# PERF.md §6).
FPS_CLUSTER_MAX_CLOUDS = 16


def fps_route(b: int) -> str:
    """K1's route for b clouds: "cluster" or "block". The count of clouds
    decides; the number of points did not, at any measured shape."""
    return "cluster" if b <= FPS_CLUSTER_MAX_CLOUDS else "block"


def _fps_cuda(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """K1 on the route `fps_route` picks (tests and timing patch it to force
    one)."""
    b, n, _ = xyz.shape
    if n > 16384:
        raise ValueError(f"farthest_point_sample: kernel takes n <= 16384, got {n}")
    route = fps_route(b)
    if route not in ("cluster", "block"):
        raise ValueError(f"farthest_point_sample: unknown route {route!r}")
    xyz = xyz.contiguous()
    out = torch.empty(b, npoint, dtype=torch.int32, device=xyz.device)
    _build.FPS(xyz.data_ptr(), out.data_ptr(), b, n, npoint, int(route == "cluster"), route=route)
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
    """FPS over a precomputed [b, n, n] distance matrix -> int32 [b, npoint]
    (counterpart of `farthest_point_sample_from_dist`)."""
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


def ffps_plain(fused: torch.Tensor, npoint: int) -> torch.Tensor:
    """Plain F-FPS. fused: f32 [b, n, c] -> int32 [b, npoint]."""
    return fps_from_dist_plain(fused_square_distance(fused), npoint)


def _ffps_cuda(fused: torch.Tensor, npoint: int) -> torch.Tensor:
    b, n, c = fused.shape
    if n > 8192 or c > 4096:
        raise ValueError(
            f"farthest_point_sample_features: kernel takes n <= 8192 and "
            f"c <= 4096, got n={n}, c={c}"
        )
    chan_major = fused.transpose(1, 2).contiguous()  # [b, c, n]: coalesced rows
    out = torch.empty(b, npoint, dtype=torch.int32, device=fused.device)
    _build.FFPS(chan_major.data_ptr(), out.data_ptr(), b, n, c, npoint)
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


# ---------------------------------------------------------------- gathers

def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points: [b, n, c], idx: int [b, m] -> [b, m, c]."""
    return points.gather(1, idx.long()[..., None].expand(-1, -1, points.shape[-1]))
