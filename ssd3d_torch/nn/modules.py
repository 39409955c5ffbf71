"""PointNet++-family modules (counterpart of `ssd3d/nn/modules.py`): the
set abstraction with fusion sampling and dilated or attention-ordered
grouping, the candidate-generation vote layer, feature propagation
(PointRCNN's decoder) and global SSG pooling, in train and eval mode, with
BatchNorm or GroupNorm (`use_gn`).

An SA layer takes the fused kernel (`ops/sa_fused.py`, K7 on the card) in
the RoI regime the JAX package fuses it in: eval mode, BatchNorm, f32,
many small clouds (n <= 512, b >= 64, as in the RCNN stage: batch x
proposals clouds of 512 pooled points), and every scale inside K7's
envelope; never under GroupNorm, which does not fold into K7's affine. The
gate looks at shapes and mode only, so a CPU run takes the same route with
the fused op's plain version.

Sampling and ball-query inputs go through `.detach()`: those ops return
integers and have no gradient, and without the detach the CPU plain F-FPS
would build an autograd graph over its [b, n, n] distance tensor. Gradients
reach the features and the (vote-shifted) centres through the grouping
gather, whose backward is the row scatter-add."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.fx.experimental.symbolic_shapes import statically_known_true

from ssd3d_torch.nn.layers import PointConv, SharedMLP
from ssd3d_torch.ops import sa_fused
from ssd3d_torch.ops.grouping import (
    ball_query_attention,
    ball_query_multi,
    gather_rows,
    group_points,
)
from ssd3d_torch.ops.interpolate import inverse_distance_weights, three_interpolate, three_nn
from ssd3d_torch.ops.sampling import (
    farthest_point_sample,
    farthest_point_sample_features,
    gather_points,
)
from ssd3d_torch.utils.profiling import span


# the RoI regime's least number of clouds for the fused route
FUSED_MIN_CLOUDS = 64


def _fusion_sample(xyz: torch.Tensor, features: torch.Tensor,
                   fps_sample_range_list: Sequence[int],
                   fps_method_list: Sequence[str],
                   npoint_list: Sequence[int]) -> torch.Tensor:
    """Multi-segment fusion sampling: the point axis is cut into consecutive
    segments (range -1: to the end), each sampled by D-FPS, F-FPS or FS (both,
    concatenated). Returns int32 indices into the original point axis."""
    bs, n = xyz.shape[:2]
    idx_parts = []
    start = 0
    for rng, method, npoint in zip(fps_sample_range_list, fps_method_list, npoint_list):
        length = (n - start) if rng == -1 else rng
        if npoint == 0:
            start += length
            continue
        seg_xyz = xyz[:, start:start + length]
        if npoint == length and method != "FS":
            idx = torch.arange(npoint, dtype=torch.int32, device=xyz.device).expand(bs, npoint)
        elif method == "D-FPS":
            idx = farthest_point_sample(seg_xyz, npoint)
        elif method in ("F-FPS", "FS"):
            fused = torch.cat([seg_xyz, features[:, start:start + length]], dim=-1)
            idx = farthest_point_sample_features(fused, npoint)
            if method == "FS":
                idx = torch.cat([idx, farthest_point_sample(seg_xyz, npoint)], dim=-1)
        else:
            raise ValueError(f"unknown fps method {method}")
        idx_parts.append(idx + start)
        start += length
    return torch.cat(idx_parts, dim=-1)


def ffps_segments(xyz: torch.Tensor, features: torch.Tensor, fps_idx: torch.Tensor,
                  fps_sample_range_list: Sequence[int], fps_method_list: Sequence[str],
                  npoint_list: Sequence[int]):
    """The F-FPS parts of a `_fusion_sample` result: a list of (fused vectors
    [b, length, c], picks into them [b, npoint]) per F-FPS or FS segment, for
    checking the picks with `ops.sampling.fps_pick_shortfall`."""
    n = xyz.shape[1]
    parts, start, col = [], 0, 0
    for rng, method, npoint in zip(fps_sample_range_list, fps_method_list, npoint_list):
        length = (n - start) if rng == -1 else rng
        taken = npoint * (2 if method == "FS" else 1)
        if method in ("F-FPS", "FS") and 0 < npoint and (npoint < length or method == "FS"):
            fused = torch.cat([xyz[:, start:start + length],
                               features[:, start:start + length]], dim=-1)
            parts.append((fused, fps_idx[:, col:col + npoint] - start))
        col += taken
        start += length
    return parts


class PointnetSAModuleMSG(nn.Module):
    """Set abstraction with multi-scale grouping and fusion sampling.

    Submodules `mlp{i}` (one per radius) and `aggregation` carry the flax
    scope names. `in_channels` is the width of the input features. With
    `use_attention` each ball fills with its most feature-distant points
    first (`ops.grouping.ball_query_attention`, one query a radius, the
    rings not dilated), as the JAX package's layer does."""

    def __init__(self, in_channels: int, radius_list, nsample_list, mlp_list,
                 bn: bool, fps_sample_range_list, fps_method_list, npoint_list,
                 dilated_group: bool, aggregation_channel: int | None,
                 aggregate: bool = True, compute_dtype: torch.dtype | None = None,
                 use_attention: bool = False, use_gn: bool = False):
        super().__init__()
        self.use_attention = use_attention
        self.use_gn = use_gn
        self.radius_list = list(radius_list)
        self.nsample_list = list(nsample_list)
        self.fps_sample_range_list = list(fps_sample_range_list)
        self.fps_method_list = list(fps_method_list)
        self.npoint_list = list(npoint_list)
        self.dilated_group = dilated_group
        self.n_scales = len(self.radius_list)
        self.mlp_list = [list(m) for m in mlp_list[:self.n_scales]]
        self.bn = bn
        self.compute_dtype = compute_dtype
        out = in_channels
        for i in range(self.n_scales):
            self.add_module(f"mlp{i}", SharedMLP(in_channels + 3, mlp_list[i], bn=bn,
                                                 compute_dtype=compute_dtype, use_gn=use_gn))
        if self.n_scales:
            out = sum(m[-1] for m in mlp_list[:self.n_scales])
        self.aggregation = None
        if aggregate and aggregation_channel is not None and self.n_scales:
            self.aggregation = PointConv(out, aggregation_channel, bn=bn,
                                         compute_dtype=compute_dtype, use_gn=use_gn)
            out = aggregation_channel
        self.out_channels = out

    def _use_fused(self, packed_src: torch.Tensor, queries):
        """The fused route: inference, BatchNorm (not GroupNorm), f32 (K7
        computes in f32), the RoI regime (n <= 512 clouds, b >= 64 of them)
        and K7's envelope. The RoI gate is the JAX package's, chosen from TPU
        measurements; both routes are timed on the H100 in `chip_smoke.py`.
        -> True or False; None where the batch is symbolic (`torch.export`)
        and b >= 64 is not known from its range: the traced program then
        decides when it runs (`torch.cond`)."""
        b, n, cp = packed_src.shape
        if not (not self.training and self.bn and not self.use_gn and self.compute_dtype is None
                and packed_src.dtype == torch.float32 and n <= 512
                and sa_fused.supports(cp, [idx.shape[2] for idx, _ in queries], self.mlp_list)):
            return False
        if isinstance(b, torch.SymInt):
            if statically_known_true(b >= FUSED_MIN_CLOUDS):
                return True
            if statically_known_true(b < FUSED_MIN_CLOUDS):
                return False
            return None
        return b >= FUSED_MIN_CLOUDS

    def _fused(self, packed_src, new_xyz, *queries):
        """Every scale and the aggregation through K7; queries: idx, cnt of
        each scale in turn."""
        pairs = list(zip(queries[0::2], queries[1::2]))
        idx_list = [idx * (cnt > 0).to(torch.int32)[..., None] for idx, cnt in pairs]
        masks = torch.stack([(cnt > 0).float() for _, cnt in pairs], dim=-1)
        return sa_fused.sa_fused_multi(
            packed_src, idx_list, new_xyz, masks,
            [getattr(self, f"mlp{i}").fold() for i in range(self.n_scales)],
            self.aggregation.fold() if self.aggregation is not None else None)

    def _grouped(self, packed_src, new_xyz, *queries, bn_momentum: float = 0.9):
        """Every scale as gather, MLP and max-pool (the MLP's last layer's,
        `SharedMLP.forward`), then the aggregation."""
        scale_feats = []
        for i, (idx, cnt) in enumerate(zip(queries[0::2], queries[1::2])):
            has_pts = (cnt > 0).to(torch.int32)
            idx = idx * has_pts[..., None]  # empty balls gather point 0
            grouped = group_points(packed_src, idx)
            grouped_xyz = grouped[..., -3:] - new_xyz[:, :, None, :]
            grouped = torch.cat([grouped[..., :-3], grouped_xyz], dim=-1)
            scale_feats.append(getattr(self, f"mlp{i}")(grouped, bn_momentum, pool=True,
                                                        has_pts=has_pts))
        new_features = torch.cat(scale_feats, dim=-1)
        if self.aggregation is not None:
            new_features = self.aggregation(new_features, bn_momentum)
        return new_features

    def forward(self, xyz: torch.Tensor, features: torch.Tensor,
                former_fps_idx: torch.Tensor | None = None,
                vote_ctr: torch.Tensor | None = None, bn_momentum: float = 0.9):
        bs = xyz.shape[0]
        with span("ssd3d.sa.sample"):
            if vote_ctr is not None:
                # CG layer: the centres are the vote outputs, not FPS picks
                npoint = vote_ctr.shape[1]
                fps_idx = torch.arange(npoint, dtype=torch.int32,
                                       device=xyz.device).expand(bs, npoint)
            else:
                fps_idx = _fusion_sample(xyz.detach(), features.detach(),
                                         self.fps_sample_range_list, self.fps_method_list,
                                         self.npoint_list)
            if former_fps_idx is not None:
                fps_idx = torch.cat([fps_idx, former_fps_idx], dim=-1)
            new_xyz = gather_points(vote_ctr if vote_ctr is not None else xyz, fps_idx)

            if self.n_scales == 0:
                # radius-less layer: a pure gather (3DSSD's pre-vote selection)
                return new_xyz, gather_points(features, fps_idx), fps_idx

        with span("ssd3d.sa.group"):
            if self.use_attention:
                # the centres' features through the row gather (K4 on the card)
                feats = features.detach()
                new_feat = gather_rows(feats, fps_idx)
                queries = [ball_query_attention(r, ns, xyz.detach(), new_xyz.detach(), feats,
                                                new_feat)
                           for r, ns in zip(self.radius_list, self.nsample_list)]
            else:
                queries = ball_query_multi(self.radius_list, self.nsample_list, xyz.detach(),
                                           new_xyz.detach(), dilated=self.dilated_group)
        with span("ssd3d.sa.mlp"):
            # one packed gather per scale instead of separate xyz / feature gathers
            packed_src = torch.cat([features, xyz], dim=-1)
            flat = tuple(t for query in queries for t in query)
            fused = self._use_fused(packed_src, queries)
            if fused is None:
                new_features = torch.cond(packed_src.shape[0] >= FUSED_MIN_CLOUDS, self._fused,
                                          self._grouped, (packed_src, new_xyz) + flat)
            elif fused:
                new_features = self._fused(packed_src, new_xyz, *flat)
            else:
                new_features = self._grouped(packed_src, new_xyz, *flat, bn_momentum=bn_momentum)
        return new_xyz, new_features, fps_idx


class VoteLayer(nn.Module):
    """Candidate-generation shift: returns (shifted xyz, features, raw
    offsets); the shift is clipped to max_translate_range, the raw offsets
    feed the vote loss."""

    def __init__(self, in_channels: int, mlp, max_translate_range, bn: bool = True,
                 compute_dtype: torch.dtype | None = None, use_gn: bool = False):
        super().__init__()
        self.mlp = SharedMLP(in_channels, mlp, bn=bn, compute_dtype=compute_dtype, use_gn=use_gn)
        # the offset conv runs in f32 whatever the compute dtype, as in flax
        self.vote_offsets = PointConv(self.mlp.out_channels, 3, bn=False, activation=False)
        self.register_buffer("limit", torch.tensor(max_translate_range, dtype=torch.float32),
                             persistent=False)
        self.out_channels = self.mlp.out_channels

    def forward(self, xyz: torch.Tensor, features: torch.Tensor, bn_momentum: float = 0.9):
        x = self.mlp(features, bn_momentum)
        offsets = self.vote_offsets(x, bn_momentum)
        limited = torch.clamp(offsets, torch.minimum(self.limit, -self.limit), self.limit.abs())
        return xyz + limited, x, offsets


class PointnetFPModule(nn.Module):
    """Feature propagation: 3-NN inverse-distance interpolation of the sparse
    layer's features onto the dense points, concatenated with the dense
    points' own features, then a shared MLP (`mlp`)."""

    def __init__(self, in_channels: int, mlp, bn: bool = True,
                 compute_dtype: torch.dtype | None = None, use_gn: bool = False):
        super().__init__()
        self.mlp = SharedMLP(in_channels, mlp, bn=bn, compute_dtype=compute_dtype, use_gn=use_gn)
        self.out_channels = self.mlp.out_channels

    def forward(self, xyz1: torch.Tensor, xyz2: torch.Tensor, feat1: torch.Tensor | None,
                feat2: torch.Tensor, bn_momentum: float = 0.9) -> torch.Tensor:
        """xyz1: dense points [b, n, 3]; xyz2: sparse [b, m, 3]; feat1:
        [b, n, c1] or None; feat2: [b, m, c2] -> [b, n, mlp[-1]]."""
        dist2, idx = three_nn(xyz1, xyz2)
        interp = three_interpolate(feat2, idx, inverse_distance_weights(dist2))
        if feat1 is not None:
            interp = torch.cat([interp, feat1], dim=-1)
        return self.mlp(interp, bn_momentum)


class PointnetSAModuleGlobal(nn.Module):
    """Global SSG pooling: a shared MLP (`mlp`) over concat(xyz, features),
    then the max over all points: [b, n, *] -> [b, mlp[-1]]."""

    def __init__(self, in_channels: int, mlp, bn: bool = True,
                 compute_dtype: torch.dtype | None = None, use_gn: bool = False):
        super().__init__()
        self.mlp = SharedMLP(in_channels + 3, mlp, bn=bn, compute_dtype=compute_dtype,
                             use_gn=use_gn)
        self.out_channels = self.mlp.out_channels

    def forward(self, xyz: torch.Tensor, features: torch.Tensor,
                bn_momentum: float = 0.9) -> torch.Tensor:
        # the whole cloud as one ball, through the one max-pool of the package
        return self.mlp(torch.cat([xyz, features], dim=-1)[:, None], bn_momentum, pool=True)[:, 0]
