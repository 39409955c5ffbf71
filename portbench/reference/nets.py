"""The plain reference of the point detectors: PointNet++ set abstraction
with fusion sampling (3DSSD's D-FPS, F-FPS and FS) and dilated multi-ring
grouping, the candidate-generation vote layer, feature propagation, global
pooling, the detection head, box decoding and NMS; the two-stage models'
proposals and refinement stage, with the RoI pooler of the configuration's
type (`poolers/<type>.py`).

It reads the configuration's architecture rows (the schema of the upstream
3DSSD repository's configs) and a flat dict of weights named by layer
scope (`backbone.layer1.mlp0.conv0.conv.kernel`, ...), computes in float32
with TF32 off, and imports nothing of the program under test. `prec`
switches every matrix product to a lower precision, for the control:
"fp8" rounds the inputs and the output of each product that the
configuration runs in bfloat16 to float8 (e4m3); "tf32" rounds every
product's inputs to TF32.

Each layer is a function of its inputs, so the reference can either run a
whole forward (`Detector.forward`, the control) or recompute one layer of
the program from the program's own inputs to it (the judge).
"""

from __future__ import annotations

from typing import Sequence

import torch

from portbench.reference import ops, poolers

BN_EPS = 1e-3


def _tf32(x: torch.Tensor) -> torch.Tensor:
    return (x.float().contiguous().view(torch.int32) & -8192).view(torch.float32)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    return x.float().clamp(-448.0, 448.0).to(torch.float8_e4m3fn).float()


class Params:
    """Weights by name, and the precision of the products. With `training`,
    BatchNorm normalises by the batch's statistics and moves its running
    ones by `bn_m` (m * running + (1 - m) * batch) in this object's dict."""

    def __init__(self, weights: dict, low_precision_products: bool, prec: str | None = None,
                 training: bool = False, bn_m: float = 0.9):
        self.w = dict(weights) if training else weights
        self.low = low_precision_products  # the config computes the MLPs in bfloat16
        self.prec = prec
        self.training = training
        self.bn_m = bn_m

    def dense(self, x: torch.Tensor, name: str, low: bool) -> torch.Tensor:
        k, b = self.w[f"{name}.kernel"], self.w[f"{name}.bias"]
        if self.prec == "fp8" and low and self.low:
            return _fp8(torch.matmul(_fp8(x), _fp8(k)) + _fp8(b))
        if self.prec == "tf32":
            return torch.matmul(_tf32(x), _tf32(k)) + b
        return torch.matmul(x.float(), k) + b

    def conv(self, x: torch.Tensor, name: str, bn: bool = True, act: bool = True) -> torch.Tensor:
        """A 1x1 conv: the product, eval-mode BatchNorm, ReLU."""
        x = self.dense(x, f"{name}.conv", low=bn)
        if bn:
            w = self.w
            if self.training:
                dims = tuple(range(x.dim() - 1))
                mean, mean2 = x.mean(dims), (x * x).mean(dims)
                var = (mean2 - mean * mean).clamp(min=0.0)
                m = self.bn_m
                with torch.no_grad():
                    w[f"{name}.bn.mean"] = m * w[f"{name}.bn.mean"] + (1.0 - m) * mean
                    w[f"{name}.bn.var"] = m * w[f"{name}.bn.var"] + (1.0 - m) * var
            else:
                mean, var = w[f"{name}.bn.mean"], w[f"{name}.bn.var"]
            inv = torch.rsqrt(var + BN_EPS) * w[f"{name}.bn.scale"]
            x = x * inv + (w[f"{name}.bn.bias"] - mean * inv)
        return torch.relu(x) if act else x

    def mlp(self, x: torch.Tensor, name: str, n: int) -> torch.Tensor:
        for i in range(n):
            x = self.conv(x, f"{name}.conv{i}")
        return x


def layer_scopes(architecture) -> list[str]:
    """Each row's module name: its scope, or scope_<row> where the scope is
    empty or already taken."""
    used, out = set(), []
    for i, row in enumerate(architecture):
        scope = row[12]
        scope = scope if scope and scope not in used else f"{scope or 'layer'}_{i}"
        used.add(scope)
        out.append(scope)
    return out


def conv_spec(name: str, c_in: int, c_out: int, bn: bool = True) -> list:
    spec = [(f"{name}.conv.kernel", (c_in, c_out), "kernel"),
            (f"{name}.conv.bias", (c_out,), "bias")]
    if bn:
        spec += [(f"{name}.bn.{k}", (c_out,), k) for k in ("scale", "bias", "mean", "var")]
    return spec


def mlp_spec(name: str, c_in: int, widths: Sequence[int]) -> list:
    spec = []
    for i, c in enumerate(widths):
        spec += conv_spec(f"{name}.conv{i}", c_in, c)
        c_in = c
    return spec


class Backbone:
    """The architecture rows as layers: xyz / feature / pick lists threaded
    as the upstream model threads them (entry 0 the input, each row
    appending its outputs, sources indexing into the lists)."""

    def __init__(self, prefix: str, architecture, in_channels: int, max_translate,
                 aggregate: bool, prefix_channels: Sequence[int] = ()):
        self.prefix = prefix
        self.rows = [list(r) for r in architecture]
        self.scopes = layer_scopes(self.rows)
        self.limit = list(max_translate)
        self.n_prefix = len(prefix_channels)
        ch = list(prefix_channels) + [in_channels]
        self.spec = []
        self.out_ch = []
        for row, scope in zip(self.rows, self.scopes):
            name = f"{prefix}.{scope}"
            c_in = ch[row[1][0]]
            kind = row[11]
            if kind == "SA_Layer":
                radii, mlps, agg = row[2], row[4], row[15]
                n_scales = len(radii)
                out = c_in
                for i in range(n_scales):
                    self.spec += mlp_spec(f"{name}.mlp{i}", c_in + 3, mlps[i])
                if n_scales:
                    out = sum(m[-1] for m in mlps[:n_scales])
                    if aggregate and agg != -1:
                        self.spec += conv_spec(f"{name}.aggregation", out, agg)
                        out = agg
            elif kind == "Vote_Layer":
                self.spec += mlp_spec(f"{name}.mlp", c_in, row[4])
                out = row[4][-1]
                self.spec += conv_spec(f"{name}.vote_offsets", out, 3, bn=False)
            elif kind == "FP_Layer":
                self.spec += mlp_spec(f"{name}.mlp", ch[row[1][1]] + c_in, row[4])
                out = row[4][-1]
            elif kind == "SA_Layer_SSG_Last":
                self.spec += mlp_spec(f"{name}.mlp", c_in + 3, row[4])
                out = row[4][-1]
            else:
                raise ValueError(f"reference: layer type {kind!r}")
            ch.append(out)
            self.out_ch.append(out)
        self.channels = ch
        self.aggregate = aggregate

    # ---- one layer, from its inputs

    def sample(self, row, xyz: torch.Tensor, feats: torch.Tensor, p: Params) -> torch.Tensor:
        """The layer's own fusion sampling (the control's picks)."""
        bs, n = xyz.shape[:2]
        parts, start = [], 0
        for rng, method, npoint in zip(row[6], row[7], row[8]):
            length = (n - start) if rng == -1 else rng
            if npoint == 0:
                start += length
                continue
            seg = xyz[:, start:start + length]
            if npoint == length and method != "FS":
                idx = torch.arange(npoint, dtype=torch.int32, device=xyz.device).expand(bs, npoint)
            elif method == "D-FPS":
                idx = ops.farthest_points(seg, npoint)
            else:
                fused = torch.cat([seg, feats[:, start:start + length]], -1)
                if p.prec == "fp8" and p.low:
                    fused = _fp8(fused)
                idx = ops.farthest_points(fused, npoint)
                if method == "FS":
                    idx = torch.cat([idx, ops.farthest_points(seg, npoint)], -1)
            parts.append(idx + start)
            start += length
        return torch.cat(parts, -1)

    def sa(self, i: int, p: Params, xyz, feats, former, vote_ctr, picks=None):
        """An SA row -> (new_xyz, new_features, picks). `picks` given: the
        program's, already judged; else the layer samples."""
        row, name = self.rows[i], f"{self.prefix}.{self.scopes[i]}"
        bs = xyz.shape[0]
        if picks is None:
            if vote_ctr is not None:
                npoint = vote_ctr.shape[1]
                picks = torch.arange(npoint, dtype=torch.int32,
                                     device=xyz.device).expand(bs, npoint)
            else:
                picks = self.sample(row, xyz, feats, p)
            if former is not None:
                picks = torch.cat([picks, former], -1)
        new_xyz = ops.gather_points(vote_ctr if vote_ctr is not None else xyz, picks)
        radii, ns_list, mlps = row[2], row[3], row[4]
        if not radii:
            return new_xyz, ops.gather_points(feats, picks), picks
        src = torch.cat([feats.float(), xyz], -1)
        outs = []
        for k, (idx, cnt) in enumerate(ops.ball_query(ops.ring_specs(radii, ns_list, row[13]),
                                                      xyz, new_xyz)):
            has = (cnt > 0)
            g = ops.group_points(src, idx * has.to(idx.dtype)[..., None])
            g = torch.cat([g[..., :-3], g[..., -3:] - new_xyz[:, :, None, :]], -1)
            g = p.mlp(g, f"{name}.mlp{k}", len(mlps[k])).amax(2)
            outs.append(g * has[..., None].float())
        out = torch.cat(outs, -1)
        if self.aggregate and row[15] != -1:
            out = p.conv(out, f"{name}.aggregation")
        return new_xyz, out, picks

    def vote(self, i: int, p: Params, xyz, feats, centres=None):
        """-> (shifted centres, features, raw offsets). `centres` given: the
        program's shifted centres stand in for the values (the gradient still
        flows through this layer's own), so that the balls grouped around
        them and the targets assigned to them are the program's."""
        name = f"{self.prefix}.{self.scopes[i]}"
        x = p.mlp(feats, f"{name}.mlp", len(self.rows[i][4]))
        off = p.conv(x, f"{name}.vote_offsets", bn=False, act=False)
        lim = torch.tensor(self.limit, dtype=torch.float32, device=xyz.device)
        shifted = xyz + torch.clamp(off, torch.minimum(lim, -lim), lim.abs())
        if centres is not None:
            shifted = shifted + (centres.float() - shifted).detach()
        return shifted, x, off

    def fp(self, i: int, p: Params, xyz1, xyz2, feat1, feat2):
        d2, idx = ops.three_nn(xyz1, xyz2)
        x = ops.interpolate(feat2.float(), idx, d2)
        if feat1 is not None:
            x = torch.cat([x, feat1.float()], -1)
        return p.mlp(x, f"{self.prefix}.{self.scopes[i]}.mlp", len(self.rows[i][4]))

    def global_sa(self, i: int, p: Params, xyz, feats):
        x = torch.cat([xyz, feats.float()], -1)
        return p.mlp(x, f"{self.prefix}.{self.scopes[i]}.mlp", len(self.rows[i][4])).amax(1)

    def run_layer(self, i: int, p: Params, lists: dict, picks=None):
        """Row i over the lists -> its outputs (new_xyz, new_feat, extra),
        where extra is the picks (SA) or the raw offsets (vote). `picks`:
        an SA row's picks, or a vote row's shifted centres, as the program
        made them."""
        row = self.rows[i]
        xyz_in, feat_in = lists["xyz"][row[0][0]], lists["features"][row[0 + 1][0]]
        kind = row[11]
        if kind == "SA_Layer":
            former = lists["picks"][row[9]] if row[9] != -1 else None
            vote_ctr = lists["xyz"][row[14]] if row[14] != -1 else None
            return self.sa(i, p, xyz_in, feat_in, former, vote_ctr, picks)
        if kind == "Vote_Layer":
            return self.vote(i, p, xyz_in, feat_in, picks)
        if kind == "FP_Layer":
            return xyz_in, self.fp(i, p, xyz_in, lists["xyz"][row[0][1]], feat_in,
                                   lists["features"][row[1][1]]), None
        return None, self.global_sa(i, p, xyz_in, feat_in), None

    def start(self, points: torch.Tensor, prefix_xyz=(), prefix_features=()) -> dict:
        return {"xyz": list(prefix_xyz) + [points[..., 0:3]],
                "features": list(prefix_features) + [points[..., 3:]],
                "picks": [None] * (self.n_prefix + 1), "vote_base": [], "vote_offset": []}

    @staticmethod
    def append(lists: dict, row, out) -> None:
        new_xyz, new_feat, extra = out
        if row[11] == "Vote_Layer":
            lists["vote_base"].append(lists["xyz"][row[0][0]])
            lists["vote_offset"].append(extra)
            extra = None
        lists["xyz"].append(new_xyz)
        lists["features"].append(new_feat)
        lists["picks"].append(extra if row[11] == "SA_Layer" else None)

    def forward(self, p: Params, points, prefix_xyz=(), prefix_features=(),
                record: dict | None = None, picks: dict | None = None) -> dict:
        """Every row from the scans; `record` gets each layer's output by
        module name, as the program's modules return it; `picks` gives an SA
        layer's picks (else it samples its own) and a vote layer's shifted
        centres, by module name."""
        lists = self.start(points, prefix_xyz, prefix_features)
        for i, row in enumerate(self.rows):
            name = f"{self.prefix}.{self.scopes[i]}"
            out = self.run_layer(i, p, lists, picks=(picks or {}).get(name))
            if record is not None:
                record[name] = (
                    out if row[11] in ("SA_Layer", "Vote_Layer") else out[1])
            self.append(lists, row, out)
        return lists


class Head:
    """The detection head: a trunk, then class and regression branches
    (128 wide, then the outputs, in float32)."""

    def __init__(self, name: str, c_in: int, trunk: Sequence[int], cls_ch: int, reg_base: int,
                 reg_ch: int, n_angle: int):
        self.name, self.trunk = name, list(trunk)
        self.reg_base, self.reg_ch, self.n_angle = reg_base, reg_ch, n_angle
        c = trunk[-1] if trunk else c_in
        reg_out = reg_base * (reg_ch + 2 * n_angle)
        self.spec = (mlp_spec(f"{name}.trunk", c_in, trunk)
                     + conv_spec(f"{name}.pred_cls_base", c, 128)
                     + conv_spec(f"{name}.pred_cls", 128, cls_ch, bn=False)
                     + conv_spec(f"{name}.pred_reg_base", c, 128)
                     + conv_spec(f"{name}.pred_reg", 128, reg_out, bn=False))

    def __call__(self, p: Params, feats: torch.Tensor) -> dict:
        x = p.mlp(feats.float(), f"{self.name}.trunk", len(self.trunk))
        cls = p.conv(p.conv(x, f"{self.name}.pred_cls_base"), f"{self.name}.pred_cls",
                     bn=False, act=False)
        reg = p.conv(p.conv(x, f"{self.name}.pred_reg_base"), f"{self.name}.pred_reg",
                     bn=False, act=False)
        bs, n = reg.shape[:2]
        reg = reg.reshape(bs, n, self.reg_base, self.reg_ch + 2 * self.n_angle)
        rc, na = self.reg_ch, self.n_angle
        return {"feature": x, "cls": cls, "offset": reg[..., :rc],
                "angle_cls": reg[..., rc:rc + na], "angle_res": reg[..., rc + na:]}


class Stage:
    """A stage's box coding and NMS, from its config section."""

    def __init__(self, cfg: dict, stage: str, cls_list):
        sc = cfg["MODEL"][stage]
        self.method = sc["REGRESSION_METHOD"]["TYPE"]
        self.half_range = sc["REGRESSION_METHOD"]["HALF_BIN_SEARCH_RANGE"]
        self.num_bins = sc["REGRESSION_METHOD"]["BIN_CLASS_NUM"]
        self.n_angle = cfg["MODEL"]["ANGLE_CLS_NUM"]
        self.softmax = sc["CLS_ACTIVATION"] == "Softmax"
        self.max_output = sc["MAX_OUTPUT_NUM"]
        self.nms_threshold = sc["NMS_THRESH"]
        self.cls_list = list(cls_list)
        self.reg_base = 1 if self.method.endswith("free") else len(self.cls_list)
        self.reg_ch = 6 if self.method != "Bin-Anchor" else self.num_bins * 4 + 4
        self.cls_ch = len(self.cls_list) + (1 if self.softmax else 0)

    def decode(self, centres, out: dict, anchors=None) -> torch.Tensor:
        if anchors is None and self.method != "Dist-Anchor-free":
            anchors = ops.class_anchors(self.cls_list, centres)
        return ops.decode(self.method, self.n_angle, self.half_range, self.num_bins, centres,
                          out["offset"], out["angle_cls"], out["angle_res"], anchors)

    def scores(self, out: dict) -> torch.Tensor:
        if self.softmax:
            return torch.softmax(out["cls"], dim=-1)[..., 1:]
        return torch.sigmoid(out["cls"])


def pooler(cfg: dict, feat: int):
    """The configuration's RoI pooler over RPN features of `feat` channels,
    from `poolers/<type>.py`."""
    row = cfg["MODEL"]["NETWORK"]["FIRST_STAGE"]["POINTS_POOLER"]
    return poolers.load(row[0])(row, feat)


class Detector:
    """3DSSD (`SingleStage`) or a two-stage model (`DoubleStage`) from a
    config dict."""

    def __init__(self, cfg: dict, nms_pre_topk: int = 0):
        self.cfg = cfg
        m = cfg["MODEL"]
        net = m["NETWORK"]
        self.two_stage = m["TYPE"] == "DoubleStage"
        self.bf16 = cfg["TPU"]["COMPUTE_DTYPE"] == "bfloat16"
        cls_list = list(cfg["DATASET"]["KITTI"]["CLS_LIST"])
        agg = net["AGGREGATION_SA_FEATURE"]
        self.first = Stage(cfg, "FIRST_STAGE", cls_list)
        name = "rpn_backbone" if self.two_stage else "backbone"
        self.backbone = Backbone(name, net["FIRST_STAGE"]["ARCHITECTURE"], 1,
                                 m["MAX_TRANSLATE_RANGE"], agg)
        self.heads = self._heads(net["FIRST_STAGE"]["HEAD"], self.backbone.channels,
                                 "rpn_head" if self.two_stage else "head", self.first)
        self.spec = list(self.backbone.spec) + [s for h, *_ in self.heads for s in h.spec]
        self.nms_pre_topk = nms_pre_topk
        if self.two_stage:
            feat = self.heads[0][0].trunk[-1] if self.heads[0][0].trunk else \
                self.backbone.channels[self.heads[0][2][0]]
            self.pooler = pooler(cfg, feat)
            self.spec += self.pooler.spec
            self.second = Stage(cfg, "SECOND_STAGE", cls_list)
            self.rcnn = Backbone("rcnn_backbone", net["SECOND_STAGE"]["ARCHITECTURE"],
                                 self.pooler.channels - 3, m["MAX_TRANSLATE_RANGE"], agg,
                                 prefix_channels=(0,))
            self.rcnn_heads = self._heads(net["SECOND_STAGE"]["HEAD"], self.rcnn.channels,
                                          "rcnn_head", self.second)
            self.spec += list(self.rcnn.spec) + [s for h, *_ in self.rcnn_heads for s in h.spec]

    @staticmethod
    def _heads(rows, channels, prefix, stage: Stage):
        out = []
        for i, (xyz_idx, feat_idx, _op, mlp, _bn, kind, scope) in enumerate(rows):
            if kind != "Det":
                raise ValueError(f"reference: head type {kind!r} not covered")
            head = Head(scope or f"{prefix}{i}", sum(channels[j] for j in feat_idx), mlp,
                        stage.cls_ch, stage.reg_base, stage.reg_ch, stage.n_angle)
            out.append((head, list(xyz_idx), list(feat_idx)))
        return out

    # ---- stages, each a function of its inputs

    @staticmethod
    def head_inputs(heads, lists: dict, i: int, fold=None):
        _, xyz_idx, feat_idx = heads[i]
        xyz = torch.cat([lists["xyz"][j] for j in xyz_idx], 1)
        feat = torch.cat([lists["features"][j] for j in feat_idx], 1)
        if fold is not None and feat.shape[0] != fold[0]:
            feat = feat.reshape(*fold, -1)
        return xyz, feat

    @staticmethod
    def merge_heads(xyzs, preds) -> dict:
        out = {"base_xyz": torch.cat(xyzs, 1)}
        for key in ("feature", "cls", "offset", "angle_cls", "angle_res"):
            out[key] = torch.cat([p[key] for p in preds], 1)
        return out

    def detections(self, out: dict) -> dict:
        """3DSSD's decode and per-class NMS."""
        boxes = self.first.decode(out["base_xyz"], out)
        return ops.class_nms(boxes, self.first.scores(out), self.first.max_output,
                             self.first.nms_threshold)

    def propose(self, rpn: dict):
        boxes = self.first.decode(rpn["base_xyz"], rpn)
        return ops.proposal_nms(boxes, self.first.scores(rpn), self.first.max_output,
                                self.first.nms_threshold, self.nms_pre_topk)

    @staticmethod
    def foreground(rpn: dict) -> torch.Tensor:
        return (torch.sigmoid(rpn["cls"].amax(-1, keepdim=True)) >= 0.5).float()

    def final(self, out: dict, proposals, pool_mask) -> dict:
        ctr = ops.boxes_bottom_to_center(proposals)[..., 0:3]
        boxes = self.second.decode(ctr, out, anchors=proposals[:, :, None, :])
        score = self.second.scores(out) * pool_mask.float()
        return ops.class_nms(boxes, score, self.second.max_output, self.second.nms_threshold)

    def forward(self, p: Params, points: torch.Tensor, record: dict | None = None) -> dict:
        """The whole inference from the scans -> detections (with the
        two-stage model's proposals), as the control computes it; `record`
        gets every layer's, head's and pool's output by module name."""
        rec = record if record is not None else {}
        lists = self.backbone.forward(p, points, record=rec)
        xyzs, preds = [], []
        for i, (head, _, _) in enumerate(self.heads):
            xyz, feat = self.head_inputs(self.heads, lists, i)
            xyzs.append(xyz)
            preds.append(head(p, feat))
            rec[head.name] = preds[-1]
        out = self.merge_heads(xyzs, preds)
        if not self.two_stage:
            return self.detections(out)
        proposals, _, valid = self.propose(out)
        pooled, has = self.pooler.forward(p, out["base_xyz"], out["feature"],
                                          self.foreground(out), proposals)
        rec[self.pooler.name] = (pooled, has)
        ctr = ops.boxes_bottom_to_center(proposals)[..., 0:3]
        rl = self.rcnn.forward(p, pooled, prefix_xyz=(ctr,), prefix_features=(None,),
                               record=rec)
        bs, n_p = proposals.shape[:2]
        xyzs, preds = [], []
        for i, (head, _, _) in enumerate(self.rcnn_heads):
            xyz, feat = self.head_inputs(self.rcnn_heads, rl, i, fold=(bs, n_p))
            xyzs.append(xyz)
            preds.append(head(p, feat))
            rec[head.name] = preds[-1]
        dets = self.final(self.merge_heads(xyzs, preds), proposals, has)
        dets["proposals"], dets["proposals_valid"] = proposals, valid
        return dets
