"""K7, the fused set abstraction, from several source trees, timed in one run on the card.

    python3 -m ssd3d_torch.utils.sa_fused_ab TREE [TREE ...]

Each TREE is a directory that holds an `ssd3d_torch` package: this checkout
(`.`), another commit's `git archive <commit> ssd3d_torch` unpacked under
`build/`, or a copy of this package with another `csrc/sa_fused.cu`. The
trees run in the order given, then in reverse (A, B, B, A), each run in a
process of its own that builds that tree's kernels and times its
`sa_fused_multi` (wrapper and kernel, by `utils.timing.cuda_ms`) at
PointRCNN's RCNN SA1 and SA2 at batch 4 (400 RoI clouds) on inputs made
from a seed, after holding it within 1e-4 of the largest |value| of its
plain version. Prints one JSON line a run and shape, then each tree's
median ms at each shape.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

# (clouds, points, input width, centres, ns, widths): RCNN SA1 and SA2
SHAPES = {"SA1": (400, 512, 259, 128, 64, (128, 128, 128)),
          "SA2": (400, 128, 131, 32, 64, (128, 128, 256))}
ITERS = 10


def worker(tree: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    from ssd3d_torch.ops import sa_fused
    from ssd3d_torch.utils.timing import cuda_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)

    def layers(ci, widths):
        out = []
        for co in widths:
            out.append((torch.randn(ci, co, device="cuda", generator=gen) * (2.0 / ci) ** 0.5,
                        torch.randn(co, device="cuda", generator=gen) * 0.1,
                        torch.rand(co, device="cuda", generator=gen) + 0.5,
                        torch.randn(co, device="cuda", generator=gen) * 0.1))
            ci = co
        return out

    for name, (b, n, cp, m, ns, widths) in SHAPES.items():
        src = torch.randn(b, n, cp, device="cuda", generator=gen)
        idx = torch.randint(0, n, (b, m, ns), device="cuda", generator=gen, dtype=torch.int32)
        ctr = torch.randn(b, m, 3, device="cuda", generator=gen)
        masks = torch.ones(b, m, 1, device="cuda")
        args = (src, [idx], ctr, masks, [layers(cp, widths)])
        want = sa_fused.sa_fused_multi_plain(*args)
        err = float((sa_fused.sa_fused_multi(*args) - want).abs().max() / want.abs().max())
        if err > 1e-4:
            raise SystemExit(f"{tree}: K7 at {name} is {err:.3g} of the largest |value| off")
        print(json.dumps(dict(tree=tree, shape=name, rel_err=err,
                              ms=cuda_ms(lambda: sa_fused.sa_fused_multi(*args), ITERS))),
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
        for name in SHAPES:
            ms = statistics.median(r["ms"] for r in runs
                                   if r["tree"] == tree and r["shape"] == name)
            print(f"{tree}  {name}: K7 {ms:.3f} ms (median of 2 runs)")
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2])
    else:
        sys.exit(main(sys.argv[1:]))
