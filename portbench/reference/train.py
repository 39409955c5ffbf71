"""The plain reference of 3DSSD's train step (the upstream trainer's losses
and optimizer, as the configuration sets them): the forward in train mode
(BatchNorm on the batch's statistics, its running statistics moved by the
schedule's momentum), the Mask assignment of the candidate points to the
GT boxes, the Center-ness classification, the anchor-free offset, the
heading bin and residual, the corner and the vote losses, their sum's
gradient by autograd, the clip of the gradient's global norm at 5, and
Adam (b1 0.9, b2 0.999, eps 1e-8, its bias corrections rounded to float32)
at the schedule's learning rate. Float32, TF32 off; nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import nets, ops

MAX_GRAD_NORM = 5.0
TWO_PI = 2.0 * math.pi
PARAM_KINDS = ("kernel", "bias", "scale")  # mean and var are running statistics


def schedule(solver: dict, step: int) -> tuple[float, float]:
    """(learning rate, BatchNorm momentum) of a step: piecewise constant on
    SOLVER.STEPS, rounded to float32."""
    k = sum(step >= b for b in solver["STEPS"])
    lr = solver["BASE_LR"] * solver["GAMMA"] ** k
    bn = min(solver["BN_DECAY_CLIP"],
             1.0 - solver["BN_INIT_DECAY"] * solver["BN_DECAY_DECAY_RATE"] ** k)
    return float(np.float32(lr)), float(np.float32(bn))


def _assigned(boxes, inside):
    idx = inside.to(torch.uint8).argmax(-1)
    return boxes[torch.arange(boxes.shape[0], device=boxes.device)[:, None], idx], idx


def huber(e, delta: float = 1.0):
    a = e.abs()
    q = torch.minimum(a, a.new_tensor(delta))
    return 0.5 * q * q + delta * (a - q)


def sigmoid_ce(x, y):
    ax = torch.where(x >= 0, x, -x)
    return torch.maximum(x, x.new_zeros(())) - x * y + torch.log1p(torch.exp(-ax))


def corners(boxes):
    ctr, l, h, w, ry = boxes[..., 0:3], boxes[..., 3], boxes[..., 4], boxes[..., 5], boxes[..., 6]
    hl, hw, zero = l / 2.0, w / 2.0, torch.zeros_like(l)
    xs = torch.stack([hl, hl, -hl, -hl] * 2, -1)
    ys = torch.stack([zero] * 4 + [-h] * 4, -1)
    zs = torch.stack([hw, -hw, -hw, hw] * 2, -1)
    return ops.rotate_points_y(torch.stack([xs, ys, zs], -1), ry) + ctr[..., None, :]


def centerness(xyz, boxes, eps: float = 1e-6):
    c = ops.rotate_points_y((xyz - boxes[..., 0:3])[..., None, :], -boxes[..., 6])[..., 0, :]
    l, h, w = boxes[..., 3], boxes[..., 4], boxes[..., 5]

    def ratio(a, b):
        return torch.minimum(a, b) / torch.maximum(a, b)

    v = (ratio(l / 2.0 - c[..., 0], c[..., 0] + l / 2.0) * ratio(-c[..., 1], c[..., 1] + h)
         * ratio(w / 2.0 - c[..., 2], c[..., 2] + w / 2.0))
    return v.clamp(min=eps).pow(1.0 / 3.0)


def angle_to_bin(angle, n: int):
    angle = torch.remainder(angle, TWO_PI)
    per = TWO_PI / n
    shifted = torch.remainder(angle + per / 2.0, TWO_PI)
    cls = torch.floor(shifted / per)
    return cls.long(), (shifted - (cls * per + per / 2.0)) / per


def losses(cfg: dict, out: dict, gt_boxes, gt_labels) -> dict:
    """3DSSD's losses of one batch (the flagship's settings: Mask assignment,
    sigmoid Center-ness, Dist-Anchor-free offsets, corner and vote losses)."""
    st = cfg["MODEL"]["FIRST_STAGE"]
    if (st["ASSIGN_METHOD"], st["CLASSIFICATION_LOSS"]["TYPE"], st["REGRESSION_METHOD"]["TYPE"],
            st["CLS_ACTIVATION"]) != ("Mask", "Center-ness", "Dist-Anchor-free", "Sigmoid"):
        raise ValueError("reference train step: only 3DSSD's losses are written")
    n_angle = cfg["MODEL"]["ANGLE_CLS_NUM"]
    xyz = out["base_xyz"]
    bs, n = xyz.shape[:2]
    with torch.no_grad():
        valid = (gt_boxes != 0).any(-1)
        inside = ops.points_in_boxes(xyz, gt_boxes).transpose(1, 2) & valid[:, None, :]
        box, idx = _assigned(gt_boxes, inside)
        labels = gt_labels[torch.arange(bs, device=xyz.device)[:, None], idx]
        near = torch.linalg.vector_norm(xyz - box[..., 0:3], dim=-1) <= \
            st["CLASSIFICATION_LOSS"]["SOFTMAX_SAMPLE_RANGE"]
        fg = inside.any(-1)
        pmask = (fg & near).float()
        nmask = (~fg).float()
        gt_cls = labels * pmask.long()
        half = box[..., 3:6] / 2.0
        zero = torch.zeros_like(half[..., 1])
        gt_bin, gt_res = angle_to_bin(box[..., 6], n_angle)
    # the offset target is taken from the candidate's own (vote-shifted)
    # position, whose gradient it carries, as the upstream trainer's encoding
    gt_off = torch.cat([(box[..., 0:3] - torch.stack([zero, half[..., 1], zero], -1)) - xyz,
                        half], -1)
    npos = pmask.sum().clamp(min=1.0)
    cls_mask = torch.maximum(pmask, nmask)
    lo, hi = st["CLASSIFICATION_LOSS"]["CENTER_NESS_LABEL_RANGE"]
    ctr = centerness(xyz.detach(), box * pmask[..., None]) * pmask * (hi - lo) + lo
    onehot = (gt_cls - 1 == 0).float()[..., None]
    cls = (sigmoid_ce(out["cls"], onehot * ctr[..., None]).mean(-1) * cls_mask).sum() \
        / cls_mask.sum().clamp(min=1.0)
    off = out["offset"][:, :, 0]
    offset = (huber(off - gt_off).sum(-1) * pmask).sum() / npos
    a_cls, a_res = out["angle_cls"][:, :, 0], out["angle_res"][:, :, 0]
    ce = -torch.log_softmax(a_cls, -1).gather(-1, gt_bin[..., None])[..., 0]
    sel = a_res.gather(-1, gt_bin[..., None])[..., 0]
    angle = (ce * pmask).sum() / npos + huber((sel - gt_res) * pmask).sum() / npos
    heading = (gt_bin.float() + sel) * (TWO_PI / n_angle)
    ctr_p = xyz + off[..., 0:3] + torch.stack([zero, off[..., 4], zero], -1)
    pred = torch.cat([ctr_p, (off[..., 3:6] * 2.0).clamp(min=0.1), heading[..., None]], -1)
    corner = (huber(corners(pred) - corners(box)).sum((-2, -1)) * pmask).sum() / npos
    base, shift = out["vote_base"][0], out["vote_offset"][0]
    with torch.no_grad():
        expand = cfg["TRAIN"]["AUGMENTATIONS"]["EXPAND_DIMS_LENGTH"]
        vin = ops.points_in_boxes(base, gt_boxes, expand).transpose(1, 2) & valid[:, None, :]
        vmask = vin.any(-1).float()
        vbox, _ = _assigned(gt_boxes, vin)
        vz = torch.zeros_like(vbox[..., 4])
        target = vbox[..., 0:3] - torch.stack([vz, vbox[..., 4] / 2.0, vz], -1) - base
    vote = (huber(target - shift).sum(-1) * vmask).sum() / vmask.sum().clamp(min=1.0)
    return {"cls": cls, "offset": offset, "angle": angle, "corner": corner, "vote": vote}


class Trainer:
    """The reference's train state: float32 leaves (parameters by name and
    BatchNorm running statistics) and Adam's moments."""

    def __init__(self, det: nets.Detector, weights: dict, spec, prec: str | None = None):
        self.det, self.prec = det, prec
        kinds = {name: kind for name, _, kind in spec}
        self.params = {k: v.detach().clone().requires_grad_(kinds[k] in PARAM_KINDS)
                       for k, v in weights.items()}
        self.mu = {k: torch.zeros_like(v) for k, v in self.params.items() if v.requires_grad}
        self.nu = {k: torch.zeros_like(v) for k in self.mu for v in (self.params[k],)}
        self.count = 0

    def step(self, batch: dict, step: int, picks: dict | None = None,
             record: dict | None = None) -> dict:
        """One optimizer step -> {"loss": total, "grads": the clipped gradient
        by name, as the optimizer gets it}. `picks`: the SA layers' picks by
        module name (else the layers sample their own); `record` gets each
        layer's output by module name."""
        cfg = self.det.cfg
        lr, bn_m = schedule(cfg["SOLVER"], step)
        p = nets.Params(self.params, self.det.bf16, self.prec, training=True, bn_m=bn_m)
        lists = self.det.backbone.forward(p, batch["points"], picks=picks, record=record)
        xyzs, preds = [], []
        for i, (head, _, _) in enumerate(self.det.heads):
            xyz, feat = self.det.head_inputs(self.det.heads, lists, i)
            xyzs.append(xyz)
            preds.append(head(p, feat))
            if record is not None:
                record[head.name] = preds[-1]
        out = self.det.merge_heads(xyzs, preds)
        out["vote_base"], out["vote_offset"] = lists["vote_base"], lists["vote_offset"]
        parts = losses(cfg, out, batch["gt_boxes"], batch["gt_labels"])
        total = sum(parts.values())
        leaves = [k for k in self.mu]
        grads = torch.autograd.grad(total, [self.params[k] for k in leaves], allow_unused=True)
        grads = [g if g is not None else torch.zeros_like(self.params[k])
                 for g, k in zip(grads, leaves)]
        with torch.no_grad():
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            if norm >= MAX_GRAD_NORM:
                grads = [(g / norm) * MAX_GRAD_NORM for g in grads]
            self.count += 1
            bc1 = float(np.float32(1) - np.float32(0.9) ** np.float32(self.count))
            bc2 = float(np.float32(1) - np.float32(0.999) ** np.float32(self.count))
            for k, g in zip(leaves, grads):
                self.mu[k].mul_(0.9).add_(g, alpha=1 - 0.9)
                self.nu[k].mul_(0.999).addcmul_(g, g, value=1 - 0.999)
                upd = (self.mu[k] / bc1) / ((self.nu[k] / bc2).sqrt() + 1e-8)
                self.params[k].add_(upd, alpha=-lr)
            for k, v in p.w.items():  # the moved running statistics
                if not v.requires_grad:
                    self.params[k] = v
        return {"loss": total.detach(), "grads": dict(zip(leaves, grads))}
