"""Detection and IoU heads (counterpart of `ssd3d/models/heads.py`), with
the nuScenes attribute / velocity branches."""

from __future__ import annotations

import torch
from torch import nn

from ssd3d_torch.nn.layers import PointConv, SharedMLP


class DetectionHead(nn.Module):
    """Shared MLP trunk, then cls and reg branches (128 -> out), and with
    `predict_attr_velo` the attribute (8 logits) and velocity (vx, vz)
    branches, each for every regression slot. The output convs run in f32
    whatever the compute dtype, as in flax."""

    def __init__(self, in_channels: int, mlp, cls_channels: int, reg_base: int,
                 reg_channels: int, num_angle_cls: int, bn: bool = True,
                 compute_dtype: torch.dtype | None = None, predict_attr_velo: bool = False):
        super().__init__()
        self.reg_base = reg_base
        self.reg_channels = reg_channels
        self.num_angle_cls = num_angle_cls
        self.trunk = SharedMLP(in_channels, mlp, bn=bn, compute_dtype=compute_dtype)
        c = self.trunk.out_channels
        self.pred_cls_base = PointConv(c, 128, bn=bn, compute_dtype=compute_dtype)
        self.pred_cls = PointConv(128, cls_channels, bn=False, activation=False)
        reg_out = reg_base * (reg_channels + num_angle_cls * 2)
        self.pred_reg_base = PointConv(c, 128, bn=bn, compute_dtype=compute_dtype)
        self.pred_reg = PointConv(128, reg_out, bn=False, activation=False)
        self.predict_attr_velo = predict_attr_velo
        if predict_attr_velo:
            self.pred_attr_base = PointConv(c, 128, bn=bn, compute_dtype=compute_dtype)
            self.pred_attr = PointConv(128, reg_base * 8, bn=False, activation=False)
            self.pred_velo_base = PointConv(c, 128, bn=bn, compute_dtype=compute_dtype)
            self.pred_velo = PointConv(128, reg_base * 2, bn=False, activation=False)

    def forward(self, features: torch.Tensor, bn_momentum: float = 0.9) -> dict:
        """features: [bs, n, c] -> dict of per-point predictions."""
        x = self.trunk(features, bn_momentum)
        cls = self.pred_cls(self.pred_cls_base(x, bn_momentum))
        reg = self.pred_reg(self.pred_reg_base(x, bn_momentum))
        bs, n = reg.shape[:2]
        reg = reg.reshape(bs, n, self.reg_base, self.reg_channels + self.num_angle_cls * 2)
        rc, na = self.reg_channels, self.num_angle_cls
        out = {
            "feature": x,
            "cls": cls,
            "offset": reg[..., :rc],
            "angle_cls": reg[..., rc:rc + na],
            "angle_res": reg[..., rc + na:],
        }
        if self.predict_attr_velo:
            attr = self.pred_attr(self.pred_attr_base(x, bn_momentum))
            velo = self.pred_velo(self.pred_velo_base(x, bn_momentum))
            out["attribute"] = attr.reshape(bs, n, self.reg_base, 8)
            out["velocity"] = velo.reshape(bs, n, self.reg_base, 2)
        return out


class IoUHead(nn.Module):
    """The IoU-prediction branch (sparse-to-dense rescoring): shared MLP
    trunk, a 128-wide conv, then one output per class, in f32 whatever the
    compute dtype, as in flax. Its output multiplies the class scores at
    decode time and is trained by `train.losses.iou_branch_loss`."""

    def __init__(self, in_channels: int, mlp, cls_channels: int, bn: bool = True,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.trunk = SharedMLP(in_channels, mlp, bn=bn, compute_dtype=compute_dtype)
        self.pred_iou_base = PointConv(self.trunk.out_channels, 128, bn=bn,
                                       compute_dtype=compute_dtype)
        self.pred_iou = PointConv(128, cls_channels, bn=False, activation=False)

    def forward(self, features: torch.Tensor, bn_momentum: float = 0.9) -> torch.Tensor:
        """features: [bs, n, c] -> predicted IoU [bs, n, cls_channels]."""
        x = self.trunk(features, bn_momentum)
        return self.pred_iou(self.pred_iou_base(x, bn_momentum))
