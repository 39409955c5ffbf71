"""The benchmark's command: one run of one cell of BENCHMARK.json.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as the last line of standard output (one JSON object)
and, as the last lines of standard error, each number the correctness check
compared beside its limit. Exits with another code than 0, and prints no
result, without a CUDA card (or with fewer than the cell asks for), and
when JAX or the JAX package has been loaded into the process.
"""

import time

T_START = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness, ranks

    cell = harness.Cell.load(harness.benchmark(), args.workload)
    chips = cell.chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    workers = ranks.start(chips)
    try:
        out = harness.run(cell, args.seed, args.seconds, bool(args.trace), device, T_START)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        codes = ranks.stop(workers)
    if out is None:  # a rank other than 0: rank 0 reports
        return 0
    if any(codes):
        print(f"portbench: a rank exited with {codes}", file=sys.stderr)
        return 4
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    lines = out.pop("_lines")
    print(json.dumps(out))
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
