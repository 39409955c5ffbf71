"""Feature interpolation of the PointRCNN decoder's FP layers (counterpart of
`ssd3d/ops/interpolate.py`).

`three_nn` finds each unknown point's three nearest known points and returns
their SQUARED distances (the reference op's contract, tf_interpolate_g.cu:24).
Its custom op (`ops/library.py`) dispatches on the device of its inputs:
CUDA tensors launch the hand-written kernel K6 (`csrc/three_nn.cu`), CPU tensors take
`three_nn_plain`. Both write d2 as ((dx*dx + dy*dy) + dz*dz) from exact
differences and fill equal distances into slots in index order, so their
indices agree exactly and their distances bit for bit. The op has no
gradient, as the reference op has none: its inputs are detached.

`three_interpolate` is the inverse-distance weighted gather of the features;
plain PyTorch on every device, as it is plain XLA in the JAX package.
"""

from __future__ import annotations

import torch

from ssd3d_torch.ops import _build

_QUERY_CHUNK = 1024  # plain version: unknowns per chunk, bounds the [b, chunk, m] tile


def _dist2(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """[b, c, 3] x [b, m, 3] -> [b, c, m], ((dx*dx + dy*dy) + dz*dz)."""
    dx = q[:, :, None, 0] - k[:, None, :, 0]
    dy = q[:, :, None, 1] - k[:, None, :, 1]
    dz = q[:, :, None, 2] - k[:, None, :, 2]
    return (dx * dx + dy * dy) + dz * dz


def three_nn_plain(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """Plain three_nn: three masked argmin passes per chunk of unknowns, as
    `_three_nn_jnp` does (argmin takes the first of equal values, the mask
    moves past it). -> (dist2 f32 [b, n, 3], idx int32 [b, n, 3])."""
    m = xyz2.shape[1]
    iota = torch.arange(m, device=xyz2.device)
    dists, idxs = [], []
    for q0 in range(0, xyz1.shape[1], _QUERY_CHUNK):
        work = _dist2(xyz1[:, q0:q0 + _QUERY_CHUNK], xyz2)
        vals, ids = [], []
        for _ in range(3):
            i = work.argmin(-1)
            vals.append(work.gather(-1, i[..., None])[..., 0])
            ids.append(i)
            work = work.masked_fill(iota == i[..., None], float("inf"))
        dists.append(torch.stack(vals, -1))
        idxs.append(torch.stack(ids, -1))
    return torch.cat(dists, 1), torch.cat(idxs, 1).to(torch.int32)


# K6 (csrc/three_nn.cu) takes one unknown a thread; where b * n threads give
# fewer than about 8 warps on each of the H100's 132 SMs, the knowns split
# into S slices scanned by neighbouring lanes, each slice keeping at least
# 8 knowns (the S that won at each FP shape, PERF.md §6).
THREE_NN_FILL_THREADS = 8 * 32 * 132
THREE_NN_MAX_SLICES = 8
THREE_NN_MIN_SLICE = 8


def three_nn_slices(b: int, n: int, m: int) -> int:
    """K6's S for b clouds of n unknowns and m knowns: a power of two up to
    8, doubled while b * n * S falls short of THREE_NN_FILL_THREADS and each
    slice keeps THREE_NN_MIN_SLICE knowns."""
    s = 1
    while (s < THREE_NN_MAX_SLICES and b * n * s < THREE_NN_FILL_THREADS
           and m >= 2 * s * THREE_NN_MIN_SLICE):
        s *= 2
    return s


@_build.on_input_device
def _three_nn_cuda(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """K6 with the slices `three_nn_slices` gives (timing patches it to
    force others)."""
    b, n, _ = xyz1.shape
    m = xyz2.shape[1]
    xyz1, xyz2 = xyz1.contiguous(), xyz2.contiguous()
    dist = torch.empty(b, n, 3, dtype=torch.float32, device=xyz1.device)
    idx = torch.empty(b, n, 3, dtype=torch.int32, device=xyz1.device)
    _build.THREE_NN(xyz1.data_ptr(), xyz2.data_ptr(), dist.data_ptr(), idx.data_ptr(), b, n, m,
                    three_nn_slices(b, n, m))
    return dist, idx


def three_nn(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """3 nearest known points of each unknown point.

    xyz1 (unknown): f32 [b, n, 3]; xyz2 (known): f32 [b, m, 3], m >= 3
    -> (dist2 f32 [b, n, 3], idx int32 [b, n, 3]), nearest first."""
    for name, t in (("xyz1", xyz1), ("xyz2", xyz2)):
        if t.dim() != 3 or t.shape[-1] != 3 or t.dtype != torch.float32:
            raise ValueError(f"three_nn: {name} must be f32 [b, *, 3], got {t.dtype} "
                             f"{tuple(t.shape)}")
    if xyz1.shape[0] != xyz2.shape[0] or xyz2.shape[1] < 3:
        raise ValueError(f"three_nn: needs equal batches and at least 3 knowns, got "
                         f"{tuple(xyz1.shape)} and {tuple(xyz2.shape)}")
    _build.require_cuda("three_nn", xyz1, xyz2)
    return torch.ops.ssd3d.three_nn(xyz1.detach(), xyz2.detach())


def k_interpolate(points: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Weighted gather: points [b, m, c]; idx int [b, n, k]; weight [b, n, k]
    -> [b, n, c] = sum over k of weight * points[idx]."""
    b, n, k = idx.shape
    flat = idx.reshape(b, n * k).long()
    gathered = points.gather(1, flat[..., None].expand(-1, -1, points.shape[-1]))
    return (gathered.reshape(b, n, k, -1) * weight[..., None]).sum(2)


def three_interpolate(points: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """points: [b, m, c]; idx: [b, n, 3]; weight: [b, n, 3] -> [b, n, c]."""
    return k_interpolate(points, idx, weight)


def inverse_distance_weights(dist2: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Normalised 1/d weights from three_nn's squared distances (the
    reference takes 1/dist of the op's output, which is d2)."""
    inv = 1.0 / dist2.clamp(min=eps)
    return inv / inv.sum(-1, keepdim=True)
