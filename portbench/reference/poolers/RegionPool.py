"""PointRCNN's RoI pooler, `RegionPool`: the first `points` RPN points inside
each proposal grown by the context range, in the proposal's frame, with the
align MLP over (canonical xyz, mask, distance) and the RPN features. The
RCNN gets those points. The interface is in `poolers/__init__.py`.

POINTS_POOLER row: [type, info keys, align widths, ns, context range,
(PointsPool's grid and vfe widths), bn, scope].
"""

from __future__ import annotations

import torch

from portbench import judge, rooflines
from portbench.reference import nets, ops


class Pooler:
    def __init__(self, row, feat: int):
        self.info = [k for k in row[1] if k in ("mask", "dist")]
        self.points, self.context, self.align = row[3], row[4], list(row[2])
        self.name = row[8] or "roi_pool"
        self.spec = nets.mlp_spec(f"{self.name}.align", 3 + len(self.info), self.align)
        self.channels = 3 + self.align[-1] + feat
        self.macs = self.points * rooflines.mlp_macs(3 + len(self.info), self.align)

    def watched(self) -> list[str]:
        return [self.name]

    def forward(self, p: nets.Params, base_xyz, base_feat, mask, proposals):
        """-> ([bs * p, points, c], has-points int32 [bs, p, 1])."""
        grown = torch.cat([proposals[..., 0:3], proposals[..., 3:6] + self.context,
                           proposals[..., 6:7]], -1)
        idx, cnt = ops.first_k(ops.points_in_boxes(base_xyz, grown), self.points)
        has = (cnt > 0).to(torch.int32)[..., None]
        idx = idx * has
        pxyz = ops.group_points(base_xyz, idx)
        pfeat = ops.group_points(base_feat.float(), idx)
        info = []
        for key in self.info:
            info.append(ops.group_points(mask, idx) if key == "mask"
                        else pxyz.square().sum(-1, keepdim=True).sqrt())
        canon = ops.rotate_points_y(pxyz - grown[:, :, None, 0:3], -grown[..., 6])
        enc = p.mlp(torch.cat([canon] + info, -1), f"{self.name}.align", len(self.align))
        out = torch.cat([canon, enc, pfeat], -1)
        bs, n_p, ns, c = out.shape
        return out.reshape(bs * n_p, ns, c), has

    def judge(self, p: nets.Params, rpn: dict, mask, proposals, outputs: dict,
              v: judge.Verdict):
        """The pooled points against the reference's pool of the program's
        proposals; the has-points flag slot by slot."""
        got = outputs.get(self.name)
        if got is None:
            v.fail(f"{self.name}: not run")
            return None
        pooled, has = self.forward(p, rpn["base_xyz"], rpn["feature"], mask, proposals)
        v.gap(f"{self.name} pooled", got[0], pooled)
        v.dets_off += judge.off_slots(got[1], has)
        return got
