"""K4, the row gather, from several source trees, timed in one run on the card.

    python3 -m ssd3d_torch.utils.gather_ab TREE [TREE ...]

Each TREE is a directory that holds an `ssd3d_torch` package: this checkout
(`.`), or another commit's `git archive <commit> ssd3d_torch` unpacked under
`build/`. The trees run in the order given, then in reverse (A, B, B, A),
each run in a process of its own that builds that tree's kernels and times
its `_gather_rows` and `torch.gather` at the K4 shapes of the three paths
with this tree's `utils.timing.cuda_ms`. Sources and indices are made from
a seed (indices uniform over the source's rows). Prints one JSON line a run,
then a tree's median ms and median ratio to `torch.gather` at each shape.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

# (b, n, c, rows a cloud): 3DSSD SA1-SA3 and CG-SA, RegionPool's xyz,
# features and mask (PointRCNN, batch 4, 100 proposals of 512 points)
SHAPES = ((8, 16384, 4, 262144), (8, 4096, 67, 65536), (8, 1024, 131, 16384),
          (8, 512, 259, 8192), (4, 16384, 3, 51200), (4, 16384, 128, 51200),
          (4, 16384, 1, 51200))
ITERS = 20


def worker(tree: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve()))
    import importlib.util

    import torch

    from ssd3d_torch.ops import grouping

    spec = importlib.util.spec_from_file_location("timing", Path(__file__).with_name("timing.py"))
    timing = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timing)
    gen = torch.Generator().manual_seed(0)
    for b, n, c, rows in SHAPES:
        src = torch.randn(b, n, c, generator=gen).cuda()
        idx = torch.randint(0, n, (b, rows), generator=gen, dtype=torch.int32).cuda()
        wide = idx.long()[..., None].expand(-1, -1, c)
        got = grouping._gather_rows(src, idx)
        if not torch.equal(got, src.gather(1, wide)):
            raise SystemExit(f"{tree}: K4 differs from torch.gather at {[b, n, c, rows]}")
        print(json.dumps(dict(tree=tree, shape=f"[{b}, {n}, {c}] x {rows} rows",
                              ms=timing.cuda_ms(lambda: grouping._gather_rows(src, idx), ITERS),
                              library_ms=timing.cuda_ms(lambda: src.gather(1, wide), ITERS))),
              flush=True)


def main(trees: list[str]) -> int:
    runs = []
    for tree in trees + trees[::-1]:
        out = subprocess.run([sys.executable, __file__, "--worker", tree], check=True,
                             capture_output=True, text=True).stdout
        for line in out.splitlines():
            print(line, flush=True)
            if line.startswith("{"):
                runs.append(json.loads(line))
    for tree in trees:
        for b, n, c, rows in SHAPES:
            shape = f"[{b}, {n}, {c}] x {rows} rows"
            mine = [r for r in runs if r["tree"] == tree and r["shape"] == shape]
            ms = statistics.median(r["ms"] for r in mine)
            ratio = statistics.median(r["ms"] / r["library_ms"] for r in mine)
            print(f"{tree}  {shape}: K4 {ms:.4f} ms, K4 / torch.gather {ratio:.2f} "
                  f"(median of {len(mine)} runs)")
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2])
    else:
        sys.exit(main(sys.argv[1:]))
