"""The RoI poolers of the two-stage detectors, one file each, named by the
pooler's type, the first entry of the configuration's `POINTS_POOLER` row:
`RegionPool.py` (PointRCNN), and one file more for each type a
configuration adds. A type with no file here is not covered.

Each file defines `Pooler(row, feat)`, built from the `POINTS_POOLER` row
and the channels of the RPN features it pools, with:

- `name`: the pooler's module scope in the program and the reference
  (`row[8]`, else "roi_pool");
- `spec`: its weights [(name, shape, kind)], drawn in this order after the
  RPN's (`weights.make`);
- `points`, `channels`: the points a RoI and the channels of each point
  (canonical xyz first) that it hands to the RCNN;
- `macs`: its multiply-adds a RoI;
- `forward(p, base_xyz, base_feat, mask, proposals) -> (pooled [bs * p,
  points, channels], has-points int32 [bs, p, 1])`, in the reference's
  float32 (`nets.Params`);
- `watched()`: the program's modules whose outputs its judge step reads
  (the recorder hooks them), by default its own scope;
- `judge(p, rpn, mask, proposals, outputs, v)`: its judge step. From the
  captured `outputs`, the RPN's merged head outputs `rpn` (`base_xyz`,
  `feature`), the foreground mask and the program's proposals, it adds its
  numbers to the `judge.Verdict` `v` and returns the program's (pooled,
  has) that the RCNN is judged from, or None where the pooler did not run.
"""

from __future__ import annotations

import functools
import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[2]


def load(kind: str, directory: Path | None = None):
    """The `Pooler` class of the RoI pooler type `kind`, from `<kind>.py` in
    `directory` (by default this folder)."""
    path = Path(directory or HERE) / f"{kind}.py"
    if not path.is_file():
        shown = path.relative_to(ROOT) if path.is_relative_to(ROOT) else path
        raise ValueError(f"reference: RoI pooler {kind!r} not covered: add {shown}")
    return _pooler_class(path)


@functools.cache
def _pooler_class(path: Path):
    spec = importlib.util.spec_from_file_location(f"portbench_pooler_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.Pooler
