"""Box decoding for the anchor-free 3DSSD head (counterpart of
`ssd3d/core/box_coders.py`). Only the inference direction of
'Dist-Anchor-free' is ported; the other codecs and the encoders come with
training (ROADMAP Queue 1 item 8) and PointRCNN (item 10)."""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def decode_class_to_angle(pred_cls: torch.Tensor, pred_res_norm: torch.Tensor,
                          bin_size: int, bin_interval: float,
                          bin_offset: float = 0.0) -> torch.Tensor:
    """Inverse of the bin encoding. pred_cls: int [...]; pred_res_norm:
    [..., bin_size] (the residual of the chosen bin is used)."""
    onehot = torch.nn.functional.one_hot(pred_cls, bin_size).to(pred_res_norm.dtype)
    res = (onehot * pred_res_norm).sum(-1)
    return (pred_cls.to(pred_res_norm.dtype) + res + bin_offset) * bin_interval


def decode_dist_anchor_free(center_xyz, det_offset, det_angle_cls, det_angle_res,
                            num_angle_cls: int) -> torch.Tensor:
    """det_offset: [bs, n, 6] = (3 translate, 3 half-size) -> boxes [bs, n, 7]."""
    angle_bin = det_angle_cls.argmax(-1)
    pred_angle = decode_class_to_angle(
        angle_bin, det_angle_res, num_angle_cls, TWO_PI / num_angle_cls
    )
    half = det_offset[..., 3:6]
    ctr = center_xyz + det_offset[..., 0:3]
    zero = torch.zeros_like(half[..., 1])
    ctr = ctr + torch.stack([zero, half[..., 1], zero], dim=-1)  # volumetric -> bottom face
    lhw = (half * 2.0).clamp(min=0.1)
    return torch.cat([ctr, lhw, pred_angle[..., None]], dim=-1)


class BoxCoder:
    """Decode over [bs, points, cls, ...] tensors."""

    def __init__(self, method: str, num_angle_cls: int):
        if method != "Dist-Anchor-free":
            raise NotImplementedError(
                f"BoxCoder: only 'Dist-Anchor-free' is ported, got {method!r} "
                f"(ROADMAP Queue 1 item 10)"
            )
        self.method = method
        self.num_angle_cls = num_angle_cls

    @property
    def reg_channels(self) -> int:
        return 6

    def decode(self, center_xyz, det_offset, det_angle_cls, det_angle_res,
               anchors) -> torch.Tensor:
        """-> pred boxes_3d [bs, pts, cls, 7]."""
        bs, pts, cls_num = det_offset.shape[:3]
        off = det_offset.reshape(bs, pts * cls_num, -1)
        a_cls = det_angle_cls.reshape(bs, pts * cls_num, self.num_angle_cls)
        a_res = det_angle_res.reshape(bs, pts * cls_num, self.num_angle_cls)
        out = decode_dist_anchor_free(center_xyz, off, a_cls, a_res, self.num_angle_cls)
        return out.reshape(bs, pts, cls_num, 7)


class AnchorGenerator:
    """Anchor-free per-point anchors: the point itself."""

    def __init__(self, dataset_type: str, cls_list, method: str):
        if not method.endswith("free"):
            raise NotImplementedError(
                f"AnchorGenerator: only anchor-free methods are ported, got "
                f"{method!r} (ROADMAP Queue 1 item 10)"
            )
        self.cls_list = list(cls_list)
        self.anchor_free = True

    def __call__(self, points: torch.Tensor) -> torch.Tensor:
        """points [bs, n, 3] -> anchors [bs, n, 1, 3]."""
        return points[:, :, None, :]
