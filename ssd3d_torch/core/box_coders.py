"""Box encoding and decoding (counterpart of `ssd3d/core/box_coders.py`),
all four regression methods:

- 'Dist-Anchor-free' (3DSSD): the offset from the point to the object's
  volumetric centre, and half sizes;
- 'Dist-Anchor': the centre's offset from the anchor and the sizes relative
  to the anchor's;
- 'Log-Anchor' (SECOND-style): the centre's offset scaled by the anchor's
  diagonal (x, z) and height (y), and log size ratios;
- 'Bin-Anchor' (PointRCNN): x and z as a bin class plus an in-bin residual,
  y and the sizes as residuals against the anchor (the class's mean size,
  or a proposal in the second stage).

The heading is a bin class plus a normalised residual, relative to the
anchor's heading for the anchor-based methods."""

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


def encode_dist_anchor(gt_ctr, gt_size, anchor_ctr, anchor_size):
    """-> (centre offset, size residual relative to the anchor's size)."""
    return gt_ctr - anchor_ctr, (gt_size - anchor_size) / anchor_size


def decode_dist_anchor(det_offset, det_angle_cls, det_angle_res, anchors,
                       num_angle_cls: int) -> torch.Tensor:
    """det_offset [bs, n, 6] against anchors [bs, n, 7] -> boxes [bs, n, 7]."""
    ctr = anchors[..., 0:3] + det_offset[..., 0:3]
    size = (anchors[..., 3:6] + det_offset[..., 3:6] * anchors[..., 3:6]).clamp(min=0.1)
    pred_angle = anchors[..., 6] + decode_class_to_angle(
        det_angle_cls.argmax(-1), det_angle_res, num_angle_cls, TWO_PI / num_angle_cls)
    return torch.cat([ctr, size, pred_angle[..., None]], dim=-1)


def encode_log_anchor(gt_ctr, gt_size, anchor_ctr, anchor_size):
    """-> (centre offset over the anchor's diagonal (x, z) and height (y),
    log size ratios)."""
    a_l, a_h, a_w = anchor_size[..., 0], anchor_size[..., 1], anchor_size[..., 2]
    a_d = torch.sqrt(a_l * a_l + a_w * a_w)
    enc_ctr = torch.stack([(gt_ctr[..., 0] - anchor_ctr[..., 0]) / a_d,
                           (gt_ctr[..., 1] - anchor_ctr[..., 1]) / a_h,
                           (gt_ctr[..., 2] - anchor_ctr[..., 2]) / a_d], dim=-1)
    return enc_ctr, torch.log(gt_size / anchor_size)


def decode_log_anchor(det_offset, det_angle_cls, det_angle_res, anchors,
                      num_angle_cls: int) -> torch.Tensor:
    """det_offset [bs, n, 6] against anchors [bs, n, 7] -> boxes [bs, n, 7]."""
    a_l, a_h, a_w = anchors[..., 3], anchors[..., 4], anchors[..., 5]
    a_d = torch.sqrt(a_l * a_l + a_w * a_w)
    ctr = torch.stack([det_offset[..., 0] * a_d + anchors[..., 0],
                       det_offset[..., 1] * a_h + anchors[..., 1],
                       det_offset[..., 2] * a_d + anchors[..., 2]], dim=-1)
    size = (torch.exp(det_offset[..., 3:6]) * anchors[..., 3:6]).clamp(min=0.1)
    pred_angle = anchors[..., 6] + decode_class_to_angle(
        det_angle_cls.argmax(-1), det_angle_res, num_angle_cls, TWO_PI / num_angle_cls)
    return torch.cat([ctr, size, pred_angle[..., None]], dim=-1)


def _encode_bin_residual(res: torch.Tensor, half_range: float, num_bins: int):
    """Scalar residual -> (bin class as f32, residual normalised in the bin)."""
    interval = half_range * 2.0 / num_bins
    bin_cls = torch.floor((res + half_range) / interval).clamp(0.0, float(num_bins - 1))
    bin_res = (res + half_range - (bin_cls * interval + interval / 2.0)) / interval
    return bin_cls, bin_res


def encode_bin_anchor(gt_ctr, gt_size, anchor_ctr, anchor_size, half_range: float,
                      num_bins: int):
    """PointRCNN target: -> (ctr4 [..., 4] = x bin, x residual, z bin, z
    residual; offset4 [..., 4] = y residual, dl, dh, dw)."""
    x_bin, x_res = _encode_bin_residual(gt_ctr[..., 0] - anchor_ctr[..., 0], half_range, num_bins)
    z_bin, z_res = _encode_bin_residual(gt_ctr[..., 2] - anchor_ctr[..., 2], half_range, num_bins)
    y_res = (gt_ctr[..., 1] - anchor_ctr[..., 1])[..., None]
    ctr = torch.stack([x_bin, x_res, z_bin, z_res], dim=-1)
    return ctr, torch.cat([y_res, gt_size - anchor_size], dim=-1)


def decode_bin_anchor(det_offset, det_angle_cls, det_angle_res, anchors, num_angle_cls: int,
                      half_range: float, num_bins: int) -> torch.Tensor:
    """det_offset: [bs, n, 4 * num_bins + 4] = x-bin logits | x residuals |
    z-bin logits | z residuals, then (y residual, dl, dh, dw); anchors
    [bs, n, 7] -> boxes [bs, n, 7]."""
    nb = num_bins
    interval = half_range * 2.0 / nb
    x_bin = det_offset[..., 0:nb].argmax(-1)
    dx = decode_class_to_angle(x_bin, det_offset[..., nb:2 * nb], nb, interval, bin_offset=0.5)
    z_bin = det_offset[..., 2 * nb:3 * nb].argmax(-1)
    dz = decode_class_to_angle(z_bin, det_offset[..., 3 * nb:4 * nb], nb, interval, bin_offset=0.5)
    rest = det_offset[..., 4 * nb:]
    px = anchors[..., 0] - half_range + dx
    pz = anchors[..., 2] - half_range + dz
    py = anchors[..., 1] + rest[..., 0]
    ctr = torch.stack([px, py, pz], dim=-1)
    size = (anchors[..., 3:6] + rest[..., 1:4]).clamp(min=0.1)
    angle_bin = det_angle_cls.argmax(-1)
    pred_angle = anchors[..., 6] + decode_class_to_angle(
        angle_bin, det_angle_res, num_angle_cls, TWO_PI / num_angle_cls)
    return torch.cat([ctr, size, pred_angle[..., None]], dim=-1)


class BoxCoder:
    """Encode and decode over [bs, points, cls, ...] tensors."""

    def __init__(self, method: str, num_angle_cls: int, half_range: float = 3.0,
                 num_bins: int = 12):
        if method not in ("Dist-Anchor-free", "Dist-Anchor", "Log-Anchor", "Bin-Anchor"):
            raise ValueError(f"BoxCoder: unknown regression method {method!r}")
        self.method = method
        self.num_angle_cls = num_angle_cls
        self.half_range = half_range
        self.num_bins = num_bins

    @property
    def reg_channels(self) -> int:
        return 6 if self.method != "Bin-Anchor" else self.num_bins * 4 + 4

    def encode(self, center_xyz, gt_boxes, anchors):
        """center_xyz [bs, pts, 3]; gt_boxes and anchors [bs, pts, cls, 7]
        -> (target [bs, pts, cls, 6 | 8], angle bin int32, angle residual).
        Anchor-free: the point is the anchor, so `anchors` is not read; the
        anchor-based methods code the heading relative to the anchor's."""
        bs, pts, cls_num, _ = gt_boxes.shape
        gt_flat = gt_boxes.reshape(bs, pts * cls_num, 7)
        if self.method == "Dist-Anchor-free":
            enc_ctr, enc_size = encode_dist_anchor_free(gt_flat[..., 0:3], gt_flat[..., 3:6],
                                                        center_xyz)
            gt_angle = gt_boxes[..., 6]
        else:
            an_flat = anchors.reshape(bs, pts * cls_num, -1)
            args = (gt_flat[..., 0:3], gt_flat[..., 3:6], an_flat[..., 0:3], an_flat[..., 3:6])
            if self.method == "Bin-Anchor":
                enc_ctr, enc_size = encode_bin_anchor(*args, self.half_range, self.num_bins)
            elif self.method == "Dist-Anchor":
                enc_ctr, enc_size = encode_dist_anchor(*args)
            else:
                enc_ctr, enc_size = encode_log_anchor(*args)
            gt_angle = gt_boxes[..., 6] - anchors[..., 6]
        enc_ctr = enc_ctr.reshape(bs, pts, cls_num, -1)
        enc_size = enc_size.reshape(bs, pts, cls_num, -1)
        angle_cls, angle_res = encode_angle_to_class(gt_angle, self.num_angle_cls)
        return torch.cat([enc_ctr, enc_size], dim=-1), angle_cls, angle_res

    def decode(self, center_xyz, det_offset, det_angle_cls, det_angle_res,
               anchors) -> torch.Tensor:
        """-> pred boxes_3d [bs, pts, cls, 7]."""
        bs, pts, cls_num = det_offset.shape[:3]
        off = det_offset.reshape(bs, pts * cls_num, -1)
        a_cls = det_angle_cls.reshape(bs, pts * cls_num, self.num_angle_cls)
        a_res = det_angle_res.reshape(bs, pts * cls_num, self.num_angle_cls)
        if self.method == "Dist-Anchor-free":
            out = decode_dist_anchor_free(center_xyz, off, a_cls, a_res, self.num_angle_cls)
        else:
            an = anchors.reshape(bs, pts * cls_num, -1)
            if self.method == "Bin-Anchor":
                out = decode_bin_anchor(off, a_cls, a_res, an, self.num_angle_cls,
                                        self.half_range, self.num_bins)
            elif self.method == "Dist-Anchor":
                out = decode_dist_anchor(off, a_cls, a_res, an, self.num_angle_cls)
            else:
                out = decode_log_anchor(off, a_cls, a_res, an, self.num_angle_cls)
        return out.reshape(bs, pts, cls_num, 7)


# per-class mean sizes (l, h, w) of the datasets the port loads, keyed
# "<dataset prefix>_<class>" (reference lib/utils/model_util.py:19-49)
MEAN_SIZES = {
    "Kitti_Car": (3.88311640418, 1.62856739989, 1.52563191462),
    "Kitti_Van": (5.06763659, 1.9007158, 2.20532825),
    "Kitti_Truck": (10.13586957, 2.58549199, 3.2520595),
    "Kitti_Pedestrian": (0.84422524, 1.76255119, 0.66068622),
    "Kitti_Person_sitting": (0.80057803, 1.27450867, 0.5983815),
    "Kitti_Cyclist": (1.76282397, 1.73698127, 0.59706367),
    "Kitti_Tram": (16.17150617, 2.53246914, 3.53079012),
    "Kitti_Misc": (3.64300781, 1.54298177, 1.92320313),
    "NuScenes_child": (0.527759, 1.376287, 0.513003),
    "NuScenes_barrier": (0.494674, 0.988850, 2.512046),
    "NuScenes_bicycle": (1.698427, 1.293067, 0.604398),
    "NuScenes_bus": (11.180965, 3.495353, 2.94905),
    "NuScenes_car": (4.619270, 1.735112, 1.960518),
    "NuScenes_construction_vehicle": (6.479316, 3.174820, 2.820066),
    "NuScenes_motorcycle": (2.110251, 1.464422, 0.776560),
    "NuScenes_pedestrian": (0.727708, 1.772415, 0.669095),
    "NuScenes_traffic_cone": (0.414219, 1.076862, 0.408734),
    "NuScenes_trailer": (12.283108, 3.865766, 2.922243),
    "NuScenes_truck": (6.885711, 2.826359, 2.509883),
}
# DATASET.TYPE -> the prefix of its classes in MEAN_SIZES
DATASET_PREFIX = {"KITTI": "Kitti", "NuScenes": "NuScenes"}


class AnchorGenerator:
    """Per-point anchors: anchor-free (the point itself) or anchor-based (the
    class's mean size, bottom face h/2 below the point, heading 0)."""

    def __init__(self, dataset_type: str, cls_list, method: str):
        prefix = DATASET_PREFIX[dataset_type]
        self.cls_list = list(cls_list)
        self.anchor_free = method.endswith("free")
        self.sizes = None if self.anchor_free else torch.tensor(
            [MEAN_SIZES[f"{prefix}_{c}"] for c in self.cls_list], dtype=torch.float32)  # [cls, 3]

    def __call__(self, points: torch.Tensor) -> torch.Tensor:
        """points [bs, n, 3] -> anchors [bs, n, cls, 7] (anchor-free:
        [bs, n, 1, 3])."""
        if self.anchor_free:
            return points[:, :, None, :]
        bs, n, _ = points.shape
        sizes = self.sizes.to(points.device).expand(bs, n, -1, 3)
        ctr = points[:, :, None, :].expand(bs, n, sizes.shape[2], 3)
        y = ctr[..., 1] + sizes[..., 1] / 2.0
        ry = torch.zeros_like(y)
        return torch.cat([ctr[..., 0:1], y[..., None], ctr[..., 2:3], sizes, ry[..., None]], -1)
