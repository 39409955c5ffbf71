"""Every CUDA kernel of the port as one `torch.library` custom op,
`torch.ops.ssd3d.<name>`.

Each op has three registrations:

- CPU: the kernel's plain PyTorch version;
- CUDA: the kernel's wrapper (`_*_cuda` in the op's module), which picks the
  route from the shape (`sampling.fps_route`, `sampling.ffps_route`,
  `grouping.ball_query_route`, `sa_fused.sa_fused_route`, the occupancy
  queries of `_build`), allocates the kernel's scratch and launches it, all
  at run time; the launch counts of `_build.Kernel` go up there;
- fake: the output shapes and dtypes, so that `torch.export` and
  `torch.compile` trace through the op without running it.

The dispatcher picks the registration by the device of the tensors: a CUDA
tensor launches the kernel or raises, a CPU tensor takes the plain version.
The public functions (`ops.sampling.farthest_point_sample`,
`ops.grouping.ball_query_multi`, `ops.sa_fused.sa_fused_multi`, ...) check
their arguments and call these ops; an exported program holds the ops
themselves, so a process that loads one imports `ssd3d_torch.ops` (which
registers them) and nothing else of the package.

No op has an autograd formula of its own: the sampling, ball-query, NMS
and three-nn ops return integers or take detached inputs, K7 runs under
`no_grad`, K10 is taken only where no gradient is recorded, and the row
gather's gradient is `grouping._GatherRows`, whose
backward is the scatter-add op. No output aliases an input.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ssd3d_torch.ops import conv_epilogue as epilogue
from ssd3d_torch.ops import grouping, interpolate, nms, sa_fused, sampling

Tensor = torch.Tensor

# op -> (the kernel source in csrc/, the JAX code it replaces). A site
# `<file>:<function>` is a `pl.pallas_call` function of
# `ssd3d/ops/pallas/<file>`; a site with a path from the repository root,
# `ssd3d/<path>:<line>`, is XLA code inside the jitted program, which the
# JAX package computes without a Pallas kernel (K8 and K9: loops; K10: the
# conv's bias, BatchNorm and ReLU, which XLA fuses).
OPS = {
    "fps": ("fps.cu", ("fps.py:_fps_pallas_batch", "fps.py:_fps_pallas_tiled")),
    "ffps": ("ffps.cu", ("fps.py:ffps_pallas_pre", "fps.py:ffps_pallas_hbm_rows")),
    "ffps_dist": ("ffps_dist.cu", ("fps.py:ffps_pallas_pre", "fps.py:ffps_pallas_hbm_rows")),
    "ball_query": ("ball_query.cu", ("ring_words.py:ring_words_pallas",)),
    "gather_rows": ("gather.cu", ("gather.py:_gather_rows_raw",)),
    "scatter_add_rows": ("scatter_add.cu", ("scatter_add.py:_scatter_add_raw",
                                            "gather.py:_gather_bwd")),
    "three_nn": ("three_nn.cu", ("three_nn.py:three_nn_pallas",)),
    "sa_fused": ("sa_fused.cu", ("sa_fused.py:_sa_fused_raw", "sa_fused.py:_sa_multi_raw")),
    "nms_keep": ("nms_keep.cu", ("ssd3d/ops/nms.py:47", "ssd3d/ops/nms.py:170")),
    "ball_query_attention": ("ball_query_attention.cu", ("ssd3d/ops/grouping.py:393",)),
    "conv_epilogue": ("conv_epilogue.cu", ("ssd3d/nn/layers.py:133",)),
}


def _picks_fake(x: Tensor, npoint: int) -> Tensor:
    return x.new_empty((x.shape[0], npoint), dtype=torch.int32)


# ---------------------------------------------------------------- K1, K2, K2m

@torch.library.custom_op("ssd3d::fps", mutates_args=(), device_types="cpu")
def fps(xyz: Tensor, npoint: int) -> Tensor:
    """D-FPS (K1): xyz f32 [b, n, 3] -> int32 [b, npoint]."""
    return sampling.fps_plain(xyz, npoint)


fps.register_kernel("cuda")(lambda xyz, npoint: sampling._fps_cuda(xyz, npoint))
fps.register_fake(_picks_fake)


@torch.library.custom_op("ssd3d::ffps", mutates_args=(), device_types="cpu")
def ffps(fused: Tensor, npoint: int) -> Tensor:
    """F-FPS over fused vectors (K2): f32 [b, n, c] -> int32 [b, npoint]."""
    return sampling.ffps_plain(fused, npoint)


ffps.register_kernel("cuda")(lambda fused, npoint: sampling._ffps_cuda(fused, npoint))
ffps.register_fake(_picks_fake)


@torch.library.custom_op("ssd3d::ffps_dist", mutates_args=(), device_types="cpu")
def ffps_dist(dist: Tensor, npoint: int) -> Tensor:
    """F-FPS over a given distance matrix (K2m): [b, n, n] -> int32 [b, npoint]."""
    return sampling.fps_from_dist_plain(dist, npoint)


ffps_dist.register_kernel("cuda")(lambda dist, npoint: sampling._ffps_dist_cuda(dist, npoint))
ffps_dist.register_fake(_picks_fake)


# ---------------------------------------------------------------- K3

def _specs(lo2, hi2, ns, annulus) -> list:
    """The op's ring arguments -> `grouping.ring_specs`' (lo2, hi2, ns, annulus)."""
    return [(float(a), float(b), int(k), bool(r)) for a, b, k, r in zip(lo2, hi2, ns, annulus)]


@torch.library.custom_op("ssd3d::ball_query", mutates_args=(), device_types="cpu")
def ball_query(xyz: Tensor, new_xyz: Tensor, lo2: Sequence[float], hi2: Sequence[float],
               ns: Sequence[int], annulus: Sequence[bool]) -> tuple[Tensor, Tensor]:
    """Multi-ring ball query (K3), ring k given by (lo2[k], hi2[k], ns[k],
    annulus[k]) as `grouping.ring_specs` makes them: xyz f32 [b, n, 3],
    new_xyz f32 [b, m, 3] -> (idx int32 [b, m, sum(ns)], the rings' slots
    side by side; cnt int32 [b, m, rings])."""
    rings = grouping.ball_query_multi_plain(_specs(lo2, hi2, ns, annulus), xyz, new_xyz)
    return (torch.cat([idx for idx, _ in rings], -1),
            torch.stack([cnt for _, cnt in rings], -1))


@ball_query.register_kernel("cuda")
def _(xyz, new_xyz, lo2, hi2, ns, annulus):
    return grouping._ball_query_cuda(_specs(lo2, hi2, ns, annulus), xyz, new_xyz)


@ball_query.register_fake
def _(xyz, new_xyz, lo2, hi2, ns, annulus):
    b, m = new_xyz.shape[:2]
    return (new_xyz.new_empty((b, m, sum(ns)), dtype=torch.int32),
            new_xyz.new_empty((b, m, len(ns)), dtype=torch.int32))


# ---------------------------------------------------------------- K4, K5

@torch.library.custom_op("ssd3d::gather_rows", mutates_args=(), device_types="cpu")
def gather_rows(points: Tensor, idx: Tensor) -> Tensor:
    """Row gather (K4): points [b, n, c] (f32 or int32 on the card), idx int
    [b, rows] -> [b, rows, c]."""
    return grouping.gather_rows_plain(points, idx)


gather_rows.register_kernel("cuda")(lambda points, idx: grouping._gather_rows_cuda(points, idx))


@gather_rows.register_fake
def _(points, idx):
    return points.new_empty((points.shape[0], idx.shape[1], points.shape[2]))


@torch.library.custom_op("ssd3d::scatter_add_rows", mutates_args=(), device_types="cpu")
def scatter_add_rows(idx: Tensor, g: Tensor, n: int) -> Tensor:
    """Row scatter-add (K5), the gather's backward: idx int [b, rows], g
    [b, rows, c] -> [b, n, c]."""
    return grouping.scatter_add_rows_plain(idx, g, n)


scatter_add_rows.register_kernel("cuda")(
    lambda idx, g, n: grouping._scatter_add_rows_cuda(idx, g, n))


@scatter_add_rows.register_fake
def _(idx, g, n):
    return g.new_empty((g.shape[0], n, g.shape[2]))


# ---------------------------------------------------------------- K6

@torch.library.custom_op("ssd3d::three_nn", mutates_args=(), device_types="cpu")
def three_nn(xyz1: Tensor, xyz2: Tensor) -> tuple[Tensor, Tensor]:
    """Three nearest knowns (K6): xyz1 f32 [b, n, 3], xyz2 f32 [b, m, 3] ->
    (dist2 f32 [b, n, 3], idx int32 [b, n, 3])."""
    return interpolate.three_nn_plain(xyz1, xyz2)


three_nn.register_kernel("cuda")(lambda xyz1, xyz2: interpolate._three_nn_cuda(xyz1, xyz2))


@three_nn.register_fake
def _(xyz1, xyz2):
    b, n = xyz1.shape[:2]
    return xyz1.new_empty((b, n, 3)), xyz1.new_empty((b, n, 3), dtype=torch.int32)


# ---------------------------------------------------------------- K7

def _layers(params, n_layers, has_agg):
    """The flat (kernel, bias, inv, shift) tensors -> (layers_list, agg_layer)."""
    quads = [tuple(params[i:i + 4]) for i in range(0, len(params), 4)]
    layers_list, at = [], 0
    for k in n_layers:
        layers_list.append(quads[at:at + k])
        at += k
    return layers_list, (quads[at] if has_agg else None)


@torch.library.custom_op("ssd3d::sa_fused", mutates_args=(), device_types="cpu")
def sa_fused_op(src: Tensor, idx: Sequence[Tensor], centers: Tensor, masks: Tensor,
                params: Sequence[Tensor], n_layers: Sequence[int], has_agg: bool) -> Tensor:
    """Fused set abstraction (K7): every scale of one SA layer, then the
    aggregation layer. params: each layer's (kernel [ci, co], bias, inv,
    shift), the scales' in order (n_layers[k] for scale k), then the
    aggregation layer's where has_agg -> f32 [b, m, c_out]."""
    layers_list, agg = _layers(params, n_layers, has_agg)
    return sa_fused.sa_fused_multi_plain(src, list(idx), centers, masks, layers_list, agg)


@sa_fused_op.register_kernel("cuda")
def _(src, idx, centers, masks, params, n_layers, has_agg):
    layers_list, agg = _layers(params, n_layers, has_agg)
    widths = [[w.shape[1] for w, *_ in layers] for layers in layers_list]
    route = sa_fused.sa_fused_route(src.shape[2], [i.shape[2] for i in idx], widths)
    if route is None:
        raise ValueError(f"sa_fused: outside K7's envelope (cp={src.shape[2]}, widths={widths})")
    return sa_fused._sa_fused_cuda(src, list(idx), centers, masks, layers_list, agg, route)


@sa_fused_op.register_fake
def _(src, idx, centers, masks, params, n_layers, has_agg):
    layers_list, agg = _layers(params, n_layers, has_agg)
    c_out = agg[0].shape[1] if agg else sum(layers[-1][0].shape[1] for layers in layers_list)
    return src.new_empty((centers.shape[0], centers.shape[1], c_out), dtype=torch.float32)


# ---------------------------------------------------------------- K8, K9

@torch.library.custom_op("ssd3d::nms_keep", mutates_args=(), device_types="cpu")
def nms_keep(suppress: Tensor) -> Tensor:
    """NMS's greedy keep sweep (K8): suppress bool [r, k, k] in visiting
    order -> keep bool [r, k]."""
    return nms.nms_keep_plain(suppress)


nms_keep.register_kernel("cuda")(lambda suppress: nms._nms_keep_cuda(suppress))


@nms_keep.register_fake
def _(suppress):
    return suppress.new_empty(suppress.shape[:2], dtype=torch.bool)


@torch.library.custom_op("ssd3d::ball_query_attention", mutates_args=(), device_types="cpu")
def ball_query_attention(xyz: Tensor, new_xyz: Tensor, feats: Tensor, new_feats: Tensor,
                         a_sq: Tensor, b_sq: Tensor, r2: float, ns: int) -> tuple[Tensor, Tensor]:
    """The attention-ordered ball query (K9): xyz f32 [b, n, 3], new_xyz f32
    [b, q, 3], feats [b, n, cf] and new_feats [b, q, cf] (f32 or bf16), the
    squared norms a_sq f32 [b, q] and b_sq f32 [b, n] -> (idx int32
    [b, q, ns], cnt int32 [b, q])."""
    return grouping.ball_query_attention_plain(xyz, new_xyz, feats, new_feats, a_sq, b_sq, r2, ns)


ball_query_attention.register_kernel("cuda")(
    lambda xyz, new_xyz, feats, new_feats, a_sq, b_sq, r2, ns:
    grouping._ball_query_attention_cuda(xyz, new_xyz, feats, new_feats, a_sq, b_sq, r2, ns))


@ball_query_attention.register_fake
def _(xyz, new_xyz, feats, new_feats, a_sq, b_sq, r2, ns):
    b, q = new_xyz.shape[:2]
    return (new_xyz.new_empty((b, q, ns), dtype=torch.int32),
            new_xyz.new_empty((b, q), dtype=torch.int32))


# ---------------------------------------------------------------- K10

# K10 is called once a layer, 41 times a 3DSSD batch, on the host that paces
# that forward since K10: it is defined through `torch.library.Library`, whose
# dispatch into a Python kernel costs less host time a call than a
# `custom_op`'s wrapper (the public call 53-57 against 83 us on the H100
# machine's host), with the same three registrations.
_K10_LIB = torch.library.Library("ssd3d", "FRAGMENT")
_K10_LIB.define("conv_epilogue(Tensor y, Tensor bias, Tensor inv, Tensor shift, Tensor? has_pts, "
                "bool pool, ScalarType out_dtype) -> Tensor")
# The eval-mode PointConv epilogue (K10): y [..., c] (the product, f32 or
# bf16), bias, inv, shift f32 [c] -> relu(f32(y + bias) * inv + shift) in
# out_dtype; with pool, y [..., ns, c] -> its max over ns times has_pts (int32
# [...]) where given, f32 [..., c].
_K10_LIB.impl("conv_epilogue", epilogue.conv_epilogue_plain, "CPU")
_K10_LIB.impl("conv_epilogue", epilogue._conv_epilogue_cuda, "CUDA")


@torch.library.register_fake("ssd3d::conv_epilogue", lib=_K10_LIB)
def _(y, bias, inv, shift, has_pts, pool, out_dtype):
    return y.new_empty(epilogue.out_shape(y, pool), dtype=out_dtype)
