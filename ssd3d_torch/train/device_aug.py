"""Training augmentation on the device, inside the train step (counterpart
of `ssd3d/train/device_aug.py`, TPU.DEVICE_AUGMENT): the host loads raw
scans and GT-crop candidates at fixed shapes, and the chain below runs on
the batch's device.

Stages, per scan, in the reference's order:
1. GT-sample paste: candidate crops, snapped onto the road plane, are
   accepted in order when their enlarged rotated BEV footprint overlaps no
   live box (a GT box, or a crop accepted before them) and a GT slot is
   free; accepted crops overwrite point slots start + i * step (mod n), an
   odd step, so the slots are distinct where n is a power of two;
2. the x-flip of the scene;
3. per-object noise: each GT box tries `num_try` jitters of its centre and
   heading and takes the first whose footprint hits no other box's
   original footprint (none: it stays put), and its interior points move
   with it;
4. global rotation about y, 5. global scale.
Stages 3-5 each apply where a draw is at most TRAIN.AUGMENTATIONS.PROB.

These are the JAX module's semantics, including its documented deviations
from the host chain (`data/augment.py`): crops overwrite existing point
slots instead of re-sampling the cloud, and the noise tests each box
against the other boxes' original footprints.

Every random number is an argument (`AugDraws`): the train step draws them
from a `torch.Generator` seeded by the seed and the step (`draw`), and a
test hands in the JAX function's own draws. Plain PyTorch on every device,
batched over the scans.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ssd3d_torch.core.geometry import points_in_boxes
from ssd3d_torch.core.iou import bev_rects_overlap

NUM_TRY = 16  # per-object noise: jitters tried a box
PASTE_ENLARGE = (0.5, 2.0, 0.5)  # a crop's footprint grows by this for the collision test


@dataclasses.dataclass
class AugDraws:
    """The random numbers of one batch of bs scans, g GT slots:
    paste_start int [bs] in [0, n); paste_step int [bs] in [0, n // 2)
    (the stride is 2 * paste_step + 1); flip, rotation, scale uniform [bs];
    choice uniform [bs, 3] (whether noise, rotation and scale apply);
    noise_loc standard normal [bs, g, NUM_TRY, 3]; noise_rot uniform
    [bs, g, NUM_TRY]. Uniforms lie in [0, 1)."""

    paste_start: torch.Tensor
    paste_step: torch.Tensor
    flip: torch.Tensor
    choice: torch.Tensor
    noise_loc: torch.Tensor
    noise_rot: torch.Tensor
    rotation: torch.Tensor
    scale: torch.Tensor


def draw(gen: torch.Generator, bs: int, n: int, g: int, device) -> AugDraws:
    """A batch's draws from `gen` (a generator on `device`)."""
    def u(*shape):
        return torch.rand(*shape, generator=gen, device=device)

    return AugDraws(
        paste_start=torch.randint(0, n, (bs,), generator=gen, device=device),
        paste_step=torch.randint(0, max(n // 2, 1), (bs,), generator=gen, device=device),
        flip=u(bs), choice=u(bs, 3),
        noise_loc=torch.randn(bs, g, NUM_TRY, 3, generator=gen, device=device),
        noise_rot=u(bs, g, NUM_TRY), rotation=u(bs), scale=u(bs))


def _where(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per scan: cond [bs] picks a [bs, ...] over b."""
    return torch.where(cond.reshape(-1, *([1] * (a.dim() - 1))), a, b)


def paste_gt_samples(points, gt_boxes, gt_labels, cand_points, cand_boxes, cand_labels,
                     cand_valid, plane, start, step):
    """points [bs, n, c]; gt_boxes [bs, g, 7] zero-padded; gt_labels [bs, g];
    cand_points [bs, k, p, c] (a crop's rows past its size repeat its first
    point); cand_boxes [bs, k, 7]; cand_labels [bs, k]; cand_valid bool
    [bs, k]; plane [bs, 4] (a, b, c, d of the road plane); start, step
    [bs] (the draws) -> (points, boxes, labels)."""
    bs, n = points.shape[:2]
    k, p = cand_points.shape[1:3]
    a, b, c, d = plane.unbind(-1)
    # snap the candidates onto the plane
    plane_y = ((-d)[:, None] - a[:, None] * cand_boxes[..., 0] - c[:, None] * cand_boxes[..., 2]) \
        / b[:, None]
    dy = cand_boxes[..., 1] - plane_y  # [bs, k]
    cand_boxes = torch.cat([cand_boxes[..., 0:1], (cand_boxes[..., 1] - dy)[..., None],
                            cand_boxes[..., 2:]], -1)
    enlarged = torch.cat([cand_boxes[..., 0:3],
                          cand_boxes[..., 3:6] + cand_boxes.new_tensor(PASTE_ENLARGE),
                          cand_boxes[..., 6:7]], -1)
    cand_points = torch.cat([cand_points[..., 0:1], (cand_points[..., 1] - dy[..., None])[..., None],
                             cand_points[..., 2:]], -1)
    gt_live = (gt_boxes != 0).any(-1)  # [bs, g]
    boxes, labels = gt_boxes.clone(), gt_labels.clone()
    rows = torch.arange(bs, device=points.device)
    accepted = []
    # crops in order: each is tested against the boxes accepted before it
    for i in range(k):
        coll = bev_rects_overlap(enlarged[:, i:i + 1], boxes)[:, 0]  # [bs, g]
        live = gt_live | (labels > 0)
        ok = cand_valid[:, i] & ~(coll & live).any(-1)
        slot = live.to(torch.uint8).argmin(-1)  # the first free GT slot
        place = ok & ~live[rows, slot]
        boxes[rows, slot] = torch.where(place[:, None], cand_boxes[:, i], boxes[rows, slot])
        labels[rows, slot] = torch.where(place, cand_labels[:, i].to(labels.dtype),
                                         labels[rows, slot])
        accepted.append(place)
    accepted = torch.stack(accepted, 1)  # [bs, k]
    # accepted crops overwrite the point slots start + j * step (mod n)
    stride = step.long() * 2 + 1
    slots = (start.long()[:, None] + torch.arange(k * p, device=points.device) * stride[:, None]) % n
    write = accepted[:, :, None].expand(bs, k, p).reshape(bs, k * p)
    cur = points.gather(1, slots[..., None].expand(bs, k * p, points.shape[-1]))
    merged = torch.where(write[..., None], cand_points.reshape(bs, k * p, -1), cur)
    points = points.scatter(1, slots[..., None].expand_as(merged), merged)
    return points, boxes, labels


def flip_x(u, points, boxes):
    """Mirror the scans whose draw u [bs] is at least 0.5 across x = 0:
    x -> -x, and ry -> pi - ry (ry >= 0) or -pi - ry."""
    fpts = torch.cat([-points[..., 0:1], points[..., 1:]], -1)
    ry = boxes[..., 6]
    fry = torch.where(ry >= 0, math.pi - ry, -math.pi - ry)
    fbox = torch.cat([-boxes[..., 0:1], boxes[..., 1:6], fry[..., None]], -1)
    do = u >= 0.5
    return _where(do, fpts, points), _where(do, fbox, boxes)


def per_object_noise(points, boxes, loc_normal, rot_uniform, rotation_perturb,
                     center_noise_std):
    """Jitter each GT box by its first collision-free try. points [bs, n,
    c]; boxes [bs, g, 7]; loc_normal [bs, g, t, 3] standard normal;
    rot_uniform [bs, g, t] in [0, 1); center_noise_std (x, y, z) as the
    config gives it, in the reference's (x, z, y) order."""
    bs, g, t = rot_uniform.shape
    lo, hi = rotation_perturb
    std = loc_normal.new_tensor([center_noise_std[0], center_noise_std[2], center_noise_std[1]])
    loc = loc_normal * std
    rot = torch.clamp(rot_uniform * (hi - lo) + lo, min=lo)
    valid_gt = (boxes != 0).any(-1)  # [bs, g]
    cand = boxes[:, :, None, :].expand(bs, g, t, 7)
    cand = torch.cat([cand[..., 0:3] + loc, cand[..., 3:6], (cand[..., 6] + rot)[..., None]], -1)
    coll = bev_rects_overlap(cand.reshape(bs, g * t, 7), boxes).reshape(bs, g, t, g)
    not_self = ~torch.eye(g, dtype=torch.bool, device=boxes.device)[:, None, :]
    coll = (coll & not_self & valid_gt[:, None, None, :]).any(-1)
    ok = ~coll  # [bs, g, t]
    first_ok = ok.to(torch.uint8).argmax(-1)  # [bs, g]
    has_ok = ok.any(-1) & valid_gt
    sel_loc = loc.gather(2, first_ok[:, :, None, None].expand(bs, g, 1, 3))[:, :, 0]
    sel_rot = rot.gather(2, first_ok[:, :, None])[:, :, 0]
    sel_loc = torch.where(has_ok[..., None], sel_loc, 0.0)
    sel_rot = torch.where(has_ok, sel_rot, 0.0)
    # interior points move with their first containing box
    inside = points_in_boxes(points[..., 0:3], boxes, expand=0.1) & valid_gt[:, None, :]
    box_of = inside.to(torch.uint8).argmax(-1)  # [bs, n]
    any_in = inside.any(-1)

    def take(x):  # x [bs, g, ...] -> [bs, n, ...] by box_of
        return x.gather(1, box_of.reshape(bs, -1, *([1] * (x.dim() - 2)))
                        .expand(bs, box_of.shape[1], *x.shape[2:]))

    ctr, ang, off = take(boxes[..., 0:3]), take(sel_rot), take(sel_loc)
    rel = points[..., 0:3] - ctr
    cos_a, sin_a = torch.cos(ang), torch.sin(ang)
    rx = rel[..., 0] * cos_a + rel[..., 2] * sin_a
    rz = -rel[..., 0] * sin_a + rel[..., 2] * cos_a
    moved = torch.stack([rx, rel[..., 1], rz], -1) + ctr + off
    xyz = torch.where(any_in[..., None], moved, points[..., 0:3])
    points = torch.cat([xyz, points[..., 3:]], -1)
    boxes = torch.cat([boxes[..., 0:3] + sel_loc, boxes[..., 3:6],
                       (boxes[..., 6] + sel_rot)[..., None]], -1)
    return points, boxes


def _rotate_y(xyz: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """xyz [bs, k, 3] times the rotation [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    transposed, per scan (c, s [bs])."""
    c, s = c[:, None], s[:, None]
    x, y, z = xyz.unbind(-1)
    return torch.stack([x * c + z * s, y, -x * s + z * c], -1)


def global_rotation(u, points, boxes, rotation_range):
    """Rotate each scan about y by (2u - 1) * rotation_range."""
    ang = (u * 2 - 1) * rotation_range
    c, s = torch.cos(ang), torch.sin(ang)
    points = torch.cat([_rotate_y(points[..., 0:3], c, s), points[..., 3:]], -1)
    boxes = torch.cat([_rotate_y(boxes[..., 0:3], c, s), boxes[..., 3:6],
                       (boxes[..., 6] + ang[:, None])[..., None]], -1)
    return points, boxes


def global_scale(u, points, boxes, scale_range):
    """Scale each scan by (2u - 1) * scale_range + 1."""
    s = ((u * 2 - 1) * scale_range + 1.0)[:, None, None]
    return (torch.cat([points[..., 0:3] * s, points[..., 3:]], -1),
            torch.cat([boxes[..., 0:6] * s, boxes[..., 6:]], -1))


@torch.no_grad()
def augment_batch(batch: dict, cfg_aug, draws: AugDraws) -> dict:
    """The whole chain over a batch: points [bs, n, c], gt_boxes [bs, g, 7],
    gt_labels [bs, g], and where the loader gave them the paste's
    candidates (cand_points, cand_boxes, cand_labels, cand_valid) and the
    road plane. -> the batch with augmented points, gt_boxes, gt_labels."""
    points, boxes, labels = batch["points"], batch["gt_boxes"], batch["gt_labels"]
    if "cand_boxes" in batch:
        points, boxes, labels = paste_gt_samples(
            points, boxes, labels, batch["cand_points"], batch["cand_boxes"],
            batch["cand_labels"], batch["cand_valid"].bool(), batch["plane"],
            draws.paste_start, draws.paste_step)
    if cfg_aug.FLIP:
        points, boxes = flip_x(draws.flip, points, boxes)
    single = cfg_aug.SINGLE_AUG
    stages = (
        lambda p, b: per_object_noise(p, b, draws.noise_loc, draws.noise_rot,
                                      tuple(single.ROTATION_PERTURB),
                                      tuple(single.CENTER_NOISE_STD)),
        lambda p, b: global_rotation(draws.rotation, p, b, cfg_aug.RANDOM_ROTATION_RANGE),
        lambda p, b: global_scale(draws.scale, p, b, cfg_aug.RANDOM_SCALE_RANGE),
    )
    for i, stage in enumerate(stages):
        new_points, new_boxes = stage(points, boxes)
        do = draws.choice[:, i] <= cfg_aug.PROB[i]
        points, boxes = _where(do, new_points, points), _where(do, new_boxes, boxes)
    return dict(batch, points=points, gt_boxes=boxes, gt_labels=labels)
