"""Config-driven point backbone (counterpart of `ssd3d/models/backbone.py`).

Reads the same 16-field architecture rows (schema in the JAX module) and
threads xyz / feature / fps-index lists through the layers the same way:
entry 0 is the raw input, each layer appends its outputs, and source indices
refer into these lists. Layer modules are registered under the flax scope
names, repeated scopes deduplicated the same way (the flagship's second
`vote` becomes `vote_4`).

`use_gn` puts GroupNorm in place of BatchNorm in every layer
(MODEL.NETWORK.USE_GN), as the JAX backbone threads it.

The two-stage detector seeds the RCNN's lists with the proposal centres:
`prefix_xyz` / `prefix_features` entries stand before the raw input, and
`prefix_channels` gives the width of each prefix feature (0 for None).
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from ssd3d_torch.nn.modules import (
    PointnetFPModule,
    PointnetSAModuleGlobal,
    PointnetSAModuleMSG,
    VoteLayer,
)


class PointBackbone(nn.Module):
    """Stack of SA, Vote, FP and global-SA layers described by architecture rows.
    `in_channels` is the width of the raw per-point features (points[..., 3:])."""

    def __init__(self, architecture: Sequence[Sequence[Any]], in_channels: int,
                 max_translate_range: Sequence[float],
                 aggregation_sa_feature: bool = False,
                 compute_dtype: torch.dtype | None = None, prefix_channels: Sequence[int] = (),
                 use_gn: bool = False):
        super().__init__()
        self.n_prefix = len(prefix_channels)
        feat_ch = list(prefix_channels) + [in_channels]
        used_names: set = set()
        self.layers: list[tuple] = []  # (scope, layer_type, spec)
        for layer_i, spec in enumerate(architecture):
            (xyz_idx, feat_idx, radius_list, nsample_list, mlp_list, bn,
             fps_range_list, fps_method_list, npoint_list, former_fps_from,
             use_attention, layer_type, scope, dilated, vote_ctr_from,
             agg_channel) = spec
            scope = scope if scope and scope not in used_names else f"{scope or 'layer'}_{layer_i}"
            used_names.add(scope)
            c_in = feat_ch[feat_idx[0]]
            if layer_type == "SA_Layer":
                module = PointnetSAModuleMSG(
                    c_in, radius_list, nsample_list, mlp_list, bn,
                    fps_range_list, fps_method_list, npoint_list,
                    dilated_group=dilated,
                    aggregation_channel=agg_channel if agg_channel != -1 else None,
                    aggregate=aggregation_sa_feature,
                    compute_dtype=compute_dtype,
                    use_attention=bool(use_attention),
                    use_gn=use_gn,
                )
            elif layer_type == "Vote_Layer":
                module = VoteLayer(c_in, mlp_list, max_translate_range, bn=bn,
                                   compute_dtype=compute_dtype, use_gn=use_gn)
            elif layer_type == "FP_Layer":
                # interpolated sparse features, then the dense points' own
                module = PointnetFPModule(feat_ch[feat_idx[1]] + feat_ch[feat_idx[0]], mlp_list,
                                          bn=bn, compute_dtype=compute_dtype, use_gn=use_gn)
            elif layer_type == "SA_Layer_SSG_Last":
                module = PointnetSAModuleGlobal(c_in, mlp_list, bn=bn,
                                                compute_dtype=compute_dtype, use_gn=use_gn)
            else:
                raise ValueError(f"unknown layer type {layer_type}")
            self.add_module(scope, module)
            feat_ch.append(module.out_channels)
            self.layers.append((scope, layer_type, spec))
        self.feature_channels = feat_ch

    def forward(self, points: torch.Tensor, bn_momentum: float = 0.9,
                prefix_xyz: tuple = (), prefix_features: tuple = ()) -> dict:
        """points: [bs, n, 3 + c] -> dict of xyz / feature / fps-index lists
        and the vote outputs (base + raw offsets)."""
        if len(prefix_xyz) != self.n_prefix or len(prefix_features) != self.n_prefix:
            raise ValueError(f"PointBackbone: built for {self.n_prefix} prefix entries")
        xyz_list: list = list(prefix_xyz) + [points[..., 0:3]]
        feature_list: list = list(prefix_features) + [points[..., 3:]]
        fps_idx_list: list = [None] * (self.n_prefix + 1)
        vote_base, vote_offset = [], []
        for scope, layer_type, spec in self.layers:
            xyz_idx, feat_idx = spec[0], spec[1]
            former_fps_from, vote_ctr_from = spec[9], spec[14]
            module = getattr(self, scope)
            xyz_in = xyz_list[xyz_idx[0]]
            feat_in = feature_list[feat_idx[0]]
            if layer_type == "SA_Layer":
                former = fps_idx_list[former_fps_from] if former_fps_from != -1 else None
                vote_ctr = xyz_list[vote_ctr_from] if vote_ctr_from != -1 else None
                new_xyz, new_feat, new_fps_idx = module(xyz_in, feat_in, former, vote_ctr,
                                                       bn_momentum)
                fps_idx_list.append(new_fps_idx)
            elif layer_type == "Vote_Layer":
                new_xyz, new_feat, offsets = module(xyz_in, feat_in, bn_momentum)
                vote_base.append(xyz_in)
                vote_offset.append(offsets)
                fps_idx_list.append(None)
            elif layer_type == "FP_Layer":
                new_xyz = xyz_in
                new_feat = module(xyz_in, xyz_list[xyz_idx[1]], feat_in,
                                  feature_list[feat_idx[1]], bn_momentum)
                fps_idx_list.append(None)
            else:  # SA_Layer_SSG_Last: one feature vector per cloud, no xyz
                new_xyz = None
                new_feat = module(xyz_in, feat_in, bn_momentum)
                fps_idx_list.append(None)
            xyz_list.append(new_xyz)
            feature_list.append(new_feat)
        return {
            "xyz": xyz_list,
            "features": feature_list,
            "fps_idx": fps_idx_list,
            "vote_base": vote_base,
            "vote_offset": vote_offset,
        }
