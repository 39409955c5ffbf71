"""Box encoding and decoding for the anchor-free 3DSSD head (counterpart of
`ssd3d/core/box_coders.py`). Only 'Dist-Anchor-free' is ported; the other
codecs come with PointRCNN (ROADMAP Queue 1 item 10)."""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def encode_angle_to_class(angle: torch.Tensor, num_class: int):
    """angle [...] -> (bin int32 [...], residual in [-0.5, 0.5] [...]): shift
    by half a bin, floor-divide, normalise the residual by the bin width."""
    angle = torch.remainder(angle, TWO_PI)
    per_class = TWO_PI / num_class
    shifted = torch.remainder(angle + per_class / 2.0, TWO_PI)
    cls_f = torch.floor(shifted / per_class)
    residual = (shifted - (cls_f * per_class + per_class / 2.0)) / per_class
    return cls_f.to(torch.int32), residual


def decode_class_to_angle(pred_cls: torch.Tensor, pred_res_norm: torch.Tensor,
                          bin_size: int, bin_interval: float,
                          bin_offset: float = 0.0) -> torch.Tensor:
    """Inverse of the bin encoding. pred_cls: int [...]; pred_res_norm:
    [..., bin_size] (the residual of the chosen bin is used)."""
    onehot = torch.nn.functional.one_hot(pred_cls, bin_size).to(pred_res_norm.dtype)
    res = (onehot * pred_res_norm).sum(-1)
    return (pred_cls.to(pred_res_norm.dtype) + res + bin_offset) * bin_interval


def encode_dist_anchor_free(gt_ctr: torch.Tensor, gt_size: torch.Tensor,
                            anchor_ctr: torch.Tensor):
    """3DSSD target: (object volumetric centre - point, half sizes). gt y is
    the bottom face; the volumetric centre sits at y - h/2 (camera y down)."""
    half = gt_size / 2.0
    zero = torch.zeros_like(half[..., 1])
    enc_ctr = (gt_ctr - torch.stack([zero, half[..., 1], zero], dim=-1)) - anchor_ctr
    return enc_ctr, half


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
    """Encode and decode over [bs, points, cls, ...] tensors."""

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

    def encode(self, center_xyz, gt_boxes, anchors):
        """center_xyz [bs, pts, 3]; gt_boxes [bs, pts, cls, 7] -> (target
        [bs, pts, cls, 6], angle bin int32, angle residual). Anchor-free:
        the point is the anchor, so `anchors` is not read."""
        bs, pts, cls_num, _ = gt_boxes.shape
        gt_flat = gt_boxes.reshape(bs, pts * cls_num, 7)
        enc_ctr, enc_size = encode_dist_anchor_free(gt_flat[..., 0:3], gt_flat[..., 3:6],
                                                    center_xyz)
        enc_ctr = enc_ctr.reshape(bs, pts, cls_num, -1)
        enc_size = enc_size.reshape(bs, pts, cls_num, -1)
        angle_cls, angle_res = encode_angle_to_class(gt_boxes[..., 6], self.num_angle_cls)
        return torch.cat([enc_ctr, enc_size], dim=-1), angle_cls, angle_res

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
