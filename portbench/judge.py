"""The comparison that decides `correct` for the inference cells.

The reference follows the program layer by layer: each layer of the
program is recomputed by the plain reference (`portbench.reference`) from
the program's own inputs to that layer, which are the program's outputs
of the layers before it, and the first layer's inputs are the scans the
benchmark handed in. So a rounding that sends an F-FPS pick, a ball's
membership or an NMS keep another way at a near-tie in one layer does not
carry into the next, and every layer is held to what its own precision
allows. What a layer decides (its sampling picks, the proposals, the kept
detections) is judged by itself:

- `layer_gap`: the worst, over every layer, head and RoI pool output, of
  max |program - reference| / max |reference|.
- `picks_off`: sampling picks that fall short of the farthest distance at
  their step by more than `TIE` (relative, in float64 from exact
  differences), or that differ where the sampling is fixed (a segment
  taken whole, the vote centres, the earlier layer's picks).
- `dets_off`: detection and proposal slots (box, score, class, valid,
  index; the RoI pool's has-points flag) that differ from the reference's
  decode and NMS of the program's own head outputs, floats by more than
  `FLOAT_TOL` of the tensor's largest magnitude.
"""

from __future__ import annotations

import torch

from portbench.reference import nets, ops

# A pick may fall short of its step's farthest distance by this much
# (relative) where float32 sums of up to 131 squares round a near-tie the
# other way; a wrong pick falls short by far more.
TIE = 1e-5
# Decode and NMS recompute the same float32 operations on the program's own
# head outputs: equal up to float32 rounding.
FLOAT_TOL = 1e-6


class Verdict:
    """The numbers of one judged request, with where each worst one came from."""

    def __init__(self):
        self.layer_gap, self.where = 0.0, ""
        self.picks_off, self.dets_off = 0, 0
        self.notes: list[str] = []

    def gap(self, what: str, prog: torch.Tensor, ref: torch.Tensor) -> None:
        if prog.shape != ref.shape:
            self.layer_gap, self.where = float("inf"), f"{what}: shape {tuple(prog.shape)}"
            return
        scale = float(ref.float().abs().max()) if ref.numel() else 0.0
        err = float((prog.float() - ref.float()).abs().max()) if ref.numel() else 0.0
        g = err / max(scale, 1e-30) if err else 0.0
        if g != g:  # NaN
            g = float("inf")
        if g > self.layer_gap:
            self.layer_gap, self.where = g, what

    def merge(self, other: "Verdict") -> None:
        if other.layer_gap > self.layer_gap:
            self.layer_gap, self.where = other.layer_gap, other.where
        self.picks_off += other.picks_off
        self.dets_off += other.dets_off
        self.notes += other.notes

    def numbers(self) -> dict:
        return {"layer_gap": self.layer_gap, "picks_off": self.picks_off,
                "dets_off": self.dets_off}


def _off_slots(prog: torch.Tensor, ref: torch.Tensor) -> int:
    """Slots (leading dims [b, k]) where prog and ref differ."""
    if prog.shape != ref.shape:
        return max(prog.shape[:2].numel(), ref.shape[:2].numel())
    if prog.dtype.is_floating_point or ref.dtype.is_floating_point:
        scale = max(float(ref.float().abs().max()), 1.0) if ref.numel() else 1.0
        bad = (prog.float() - ref.float()).abs() > FLOAT_TOL * scale
    else:
        bad = prog.long() != ref.long()
    return int(bad.reshape(bad.shape[0], bad.shape[1], -1).any(-1).sum())


def _judge_picks(bb: nets.Backbone, i: int, lists: dict, picks: torch.Tensor, v: Verdict):
    """The SA row's picks against its inputs: farthest-point segments
    tie-aware, fixed ones exactly."""
    row = bb.rows[i]
    xyz, feats = lists["xyz"][row[0][0]], lists["features"][row[1][0]]
    bs = picks.shape[0]
    picks = picks.long()
    col = 0
    fixed = []  # (columns, expected)
    if row[14] != -1:
        npoint = lists["xyz"][row[14]].shape[1]
        fixed.append((slice(0, npoint), torch.arange(npoint, device=picks.device)))
        col = npoint
    else:
        n, start = xyz.shape[1], 0
        for rng, method, npoint in zip(row[6], row[7], row[8]):
            length = (n - start) if rng == -1 else rng
            if npoint == 0:
                start += length
                continue
            seg_xyz = xyz[:, start:start + length]
            if npoint == length and method != "FS":
                fixed.append((slice(col, col + npoint),
                              start + torch.arange(npoint, device=picks.device)))
                col += npoint
            else:
                parts = []
                if method == "D-FPS":
                    parts.append(seg_xyz)
                else:
                    parts.append(torch.cat([seg_xyz, feats[:, start:start + length].float()], -1))
                    if method == "FS":
                        parts.append(seg_xyz)
                for pts in parts:
                    seg = picks[:, col:col + npoint] - start
                    if seg.shape[1] != npoint or bool(((seg < 0) | (seg >= length)).any()):
                        v.picks_off += npoint * bs
                        v.notes.append(f"{bb.scopes[i]}: picks outside their segment")
                    else:
                        short = ops.pick_shortfall(pts, seg)
                        bad = int((short > TIE).sum())
                        if bad:
                            v.notes.append(f"{bb.scopes[i]}: {bad} picks short by up to "
                                           f"{float(short.max()):.3g}")
                        v.picks_off += bad
                    col += npoint
            start += length
    if row[9] != -1:
        former = lists["picks"][row[9]].long()
        fixed.append((slice(col, col + former.shape[1]), former))
        col += former.shape[1]
    if col != picks.shape[1]:
        v.picks_off += bs * max(col, picks.shape[1])
        v.notes.append(f"{bb.scopes[i]}: {picks.shape[1]} picks, {col} expected")
        return
    for cols, want in fixed:
        v.picks_off += int((picks[:, cols] != want).sum())


def judge_backbone(bb: nets.Backbone, p: nets.Params, lists: dict, outputs: dict,
                   v: Verdict) -> dict:
    """Every row of `bb` against the program's outputs (`outputs[name]`, the
    module's return value); the lists grow with the program's outputs."""
    for i, row in enumerate(bb.rows):
        name = f"{bb.prefix}.{bb.scopes[i]}"
        if name not in outputs:
            v.layer_gap, v.where = float("inf"), f"{name}: not run"
            return lists
        got = outputs[name]
        kind = row[11]
        if kind == "SA_Layer":
            prog = tuple(got)
            _judge_picks(bb, i, lists, prog[2], v)
            ref = bb.run_layer(i, p, lists, picks=prog[2])
            v.gap(f"{name} xyz", prog[0], ref[0])
            v.gap(f"{name} features", prog[1], ref[1])
        elif kind == "Vote_Layer":
            prog = tuple(got)
            ref = bb.run_layer(i, p, lists)
            for k, what in enumerate(("centres", "features", "offsets")):
                v.gap(f"{name} {what}", prog[k], ref[k])
        elif kind == "FP_Layer":
            ref = bb.run_layer(i, p, lists)
            prog = (ref[0], got, None)
            v.gap(f"{name} features", got, ref[1])
        else:
            ref = bb.run_layer(i, p, lists)
            prog = (None, got, None)
            v.gap(f"{name} features", got, ref[1])
        nets.Backbone.append(lists, row, prog)
    return lists


def judge_heads(det: nets.Detector, heads, p: nets.Params, lists: dict, outputs: dict,
                v: Verdict, fold=None) -> dict:
    """Each head from the program's features -> the program's merged head
    outputs."""
    xyzs, preds = [], []
    for i, (head, _, _) in enumerate(heads):
        xyz, feat = det.head_inputs(heads, lists, i, fold)
        ref = head(p, feat)
        got = outputs.get(head.name)
        if got is None:
            v.layer_gap, v.where = float("inf"), f"{head.name}: not run"
            return {}
        for key, val in ref.items():
            v.gap(f"{head.name} {key}", got[key], val)
        xyzs.append(xyz)
        preds.append(got)
    return det.merge_heads(xyzs, preds)


def judge_request(det: nets.Detector, p: nets.Params, points: torch.Tensor, outputs: dict,
                  dets: dict) -> Verdict:
    """One request: points [b, n, 4] as handed in, the program's module
    outputs captured in its forward (`capture.Recorder`) and its detections."""
    v = Verdict()
    lists = judge_backbone(det.backbone, p, det.backbone.start(points), outputs, v)
    if v.layer_gap == float("inf"):
        return v
    out = judge_heads(det, det.heads, p, lists, outputs, v)
    if not out:
        return v
    if not det.two_stage:
        ref = det.detections(out)
        for key in ("boxes", "scores", "classes", "valid", "index"):
            v.dets_off += _off_slots(dets[key], ref[key])
        return v
    proposals, _, valid = det.propose(out)
    v.dets_off += _off_slots(dets["proposals"], proposals)
    v.dets_off += _off_slots(dets["proposals_valid"][..., None], valid[..., None])
    prog_props = dets["proposals"].float()
    pool_out = outputs.get(det.pool_name)
    if pool_out is None:
        v.layer_gap, v.where = float("inf"), f"{det.pool_name}: not run"
        return v
    pooled, has = det.pool(p, out["base_xyz"], out["feature"], det.foreground(out), prog_props)
    v.gap(f"{det.pool_name} pooled", pool_out[0], pooled)
    v.dets_off += _off_slots(pool_out[1], has)
    ctr = ops.boxes_bottom_to_center(prog_props)[..., 0:3]
    rl = judge_backbone(det.rcnn, p, det.rcnn.start(pool_out[0], (ctr,), (None,)), outputs, v)
    if v.layer_gap == float("inf"):
        return v
    rout = judge_heads(det, det.rcnn_heads, p, rl, outputs, v, fold=prog_props.shape[:2])
    if not rout:
        return v
    ref = det.final(rout, prog_props, pool_out[1])
    for key in ("boxes", "scores", "classes", "valid", "index"):
        v.dets_off += _off_slots(dets[key], ref[key])
    return v


def watched_modules(det: nets.Detector) -> list[str]:
    """The program's modules the reference judges, named as it names them:
    every backbone layer and head, and the RoI pool and the RCNN's."""
    names = [f"{det.backbone.prefix}.{s}" for s in det.backbone.scopes]
    names += [h.name for h, _, _ in det.heads]
    if det.two_stage:
        names.append(det.pool_name)
        names += [f"{det.rcnn.prefix}.{s}" for s in det.rcnn.scopes]
        names += [h.name for h, _, _ in det.rcnn_heads]
    return names


def judge_kept(det: nets.Detector, p: nets.Params, kept: list[dict], pool: dict,
               device: torch.device, limits: dict) -> tuple[Verdict, int]:
    """The judged requests (`capture.Recorder.kept`) -> (the worst numbers
    over them, how many of them are past a limit)."""
    worst, bad = Verdict(), 0
    with torch.inference_mode():
        for rec in kept:
            v = Verdict()
            twice = [n for n, c in rec["calls"].items() if c != 1]
            if twice:
                v.layer_gap = float("inf")
                v.where = f"{twice[0]} ran {rec['calls'][twice[0]]} times"
            else:
                points = pool["points"][rec["rows"]].to(device)
                v = judge_request(det, p, points, rec["outputs"], rec["dets"])
            bad += any(val > limits[k] for k, val in v.numbers().items())
            worst.merge(v)
    return worst, bad
