"""K1 (D-FPS), K2 (F-FPS) and K6 (three_nn) from several source trees, timed
in one run on the card.

    python3 -m ssd3d_torch.utils.sampling_ab TREE [TREE ...]

Each TREE is a directory that holds an `ssd3d_torch` package: this checkout
(`.`), or another commit's `git archive <commit> ssd3d_torch` unpacked under
`build/`. The trees run in the order given, then in reverse (A, B, B, A),
each run in a process of its own that builds that tree's kernels and times
its public `farthest_point_sample` at 3DSSD's SA1 ([8, 16384, 3] -> 4096),
`farthest_point_sample_features` at SA2 ([8, 4096, 67] -> 512) and
`three_nn` at PointRCNN's four FP layers (batch 4: 16,384 x 4,096 down to
256 x 64 points) with this tree's `utils.timing.cuda_ms`, each on the route
or plan its tree picks. Points are synthetic KITTI-like scans
(`entry.synthetic_scenes`, seed 0); a layer's knowns are the first points of
its unknowns (the scans are in random order), features are seeded. K6's
indices are held to the plain version's in every run. Prints the card, one
JSON line a run, then a tree's median ms at each shape.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

FP_SHAPES = ((16384, 4096), (4096, 1024), (1024, 256), (256, 64))  # FP1-FP4
NAMES = ["K1 SA1 [8, 16384] -> 4096", "K2 SA2 [8, 4096, 67] -> 512"] + [
    f"K6 FP{i + 1} [4, {n}] x [4, {m}]" for i, (n, m) in enumerate(FP_SHAPES)]


def worker(tree: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve()))
    import importlib.util

    import torch

    from ssd3d_torch.entry import synthetic_scenes
    from ssd3d_torch.ops.interpolate import three_nn, three_nn_plain
    from ssd3d_torch.ops.sampling import farthest_point_sample, farthest_point_sample_features

    spec = importlib.util.spec_from_file_location("timing", Path(__file__).with_name("timing.py"))
    timing = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timing)
    xyz = torch.from_numpy(synthetic_scenes(8, 16384, seed=0)["points"][..., :3]).cuda()
    gen = torch.Generator().manual_seed(0)
    fused = torch.cat([xyz[:, :4096], torch.randn(8, 4096, 64, generator=gen).cuda().relu()], -1)
    calls = [lambda: farthest_point_sample(xyz, 4096),
             lambda: farthest_point_sample_features(fused, 512)]
    for n, m in FP_SHAPES:
        q, k = xyz[:4, :n].contiguous(), xyz[:4, :m].contiguous()
        if not torch.equal(three_nn(q, k)[1], three_nn_plain(q, k)[1]):
            raise SystemExit(f"{tree}: K6 indices differ from plain at {n} x {m}")
        calls.append(lambda q=q, k=k: three_nn(q, k))
    for name, fn in zip(NAMES, calls):
        iters = 5 if name.startswith(("K1", "K2")) else 20
        print(json.dumps(dict(tree=tree, shape=name, ms=timing.cuda_ms(fn, iters))), flush=True)


def main(trees: list[str]) -> int:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    runs = []
    for tree in trees + trees[::-1]:
        out = subprocess.run([sys.executable, __file__, "--worker", tree], check=True,
                             capture_output=True, text=True).stdout
        for line in out.splitlines():
            print(line, flush=True)
            if line.startswith("{"):
                runs.append(json.loads(line))
    for tree in trees:
        for name in NAMES:
            mine = [r["ms"] for r in runs if r["tree"] == tree and r["shape"] == name]
            print(f"{tree}  {name}: {statistics.median(mine):.4f} ms (median of {len(mine)} runs: "
                  + ", ".join(f"{t:.4f}" for t in mine) + ")")
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2])
    else:
        sys.exit(main(sys.argv[1:]))
