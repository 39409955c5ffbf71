"""Readings that a cell's correctness limits are set from, on the card:
the judge's numbers for sound runs of the program on many seeds, for the
control (the reference put in the program's place at the next lower
precision: fp8 for a bfloat16 configuration, TF32 for a float32 one) and
for a fault planted in the program (`faults.py`) on a few. All in one
process, each seed a short window at the cell's own load.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control fp8|tf32 --control-seeds 4,5,6] [--fault NAME --fault-seeds 7,8,9]
        [--seconds 2] [--compute-dtype float32]

`--compute-dtype` runs the program, and the reference that judges it, in
another dtype than the configuration states (a look at what a number owes
to the precision). Prints one JSON line a run: {"workload", "seed",
"side", "checks"}.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import faults  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", choices=("fp8", "tf32"))
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--compute-dtype", choices=("float32", "bfloat16"))
    args = ap.parse_args(argv)

    import torch

    from portbench import harness, ranks, variants

    if not torch.cuda.is_available():
        print("portbench: calibrate needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.Cell.load(harness.benchmark(), args.workload)
    cell.keep_group = True
    if args.compute_dtype:
        cell = variants.in_dtype(cell, args.compute_dtype)
    workers = ranks.start(cell.chips)
    runs = [(int(s), None, None) for s in args.seeds.split(",") if s]
    runs += [(int(s), args.control, None) for s in args.control_seeds.split(",") if s]
    runs += [(int(s), None, args.fault) for s in args.fault_seeds.split(",") if s]
    for seed, control, fault in runs:
        t0 = time.perf_counter()
        side = cell
        if control:
            side = variants.control(variants.with_mix(cell, min_requests=3, warmup=1), control)
        elif fault:
            side = variants.faulty(cell, fault)
        out = harness.run(side, seed, 0.0 if control else args.seconds, False, device, t0)
        if out is None:  # a rank other than 0
            continue
        lines = out.pop("_lines")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "side": control or fault or "program",
                          "correct": out["correct"], "attempted": out["attempted"],
                          "checks": {k: c["value"] for k, c in out["checks"].items()},
                          "where": lines[1], "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    if torch.distributed.is_initialized():  # every rank, then wait for ranks 1..
        torch.distributed.destroy_process_group()
    return max(ranks.stop(workers, seconds=600.0), default=0)


if __name__ == "__main__":
    sys.exit(main())
