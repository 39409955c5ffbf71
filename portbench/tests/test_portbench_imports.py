"""No module of the harness loads JAX or the JAX package, and the reference
loads nothing of the program: each checked in a fresh interpreter, by the
whole top-level name of every module in `sys.modules` (the program's
package name begins with the JAX package's, so a prefix test would not do)."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = ["jax", "jaxlib", "flax", "ssd3d"]

DRIVE = """
import importlib, json, pkgutil, sys, time
import torch
import portbench
for m in pkgutil.walk_packages(portbench.__path__, "portbench."):
    if ".tests" not in m.name:
        importlib.import_module(m.name)
from portbench import harness, variants
cell = variants.shrunk(harness.Cell.load(harness.benchmark(), "3dssd-infer-b8"), 8, batch=2,
                       pool=2, warmup=0, judged=1, min_requests=1)
out = harness.run(cell, 5, 0.0, False, torch.device("cpu"), time.perf_counter())
print(json.dumps(sorted({n.split(".")[0] for n in sys.modules})))
"""


def top_level_modules(code: str) -> set[str]:
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    assert res.returncode == 0, res.stderr[-3000:]
    return set(json.loads(res.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_jax_package():
    loaded = top_level_modules(DRIVE)
    assert "ssd3d_torch" in loaded and "portbench" in loaded
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    code = ("import json, sys\nimport portbench.reference.nets, portbench.reference.ops\n"
            "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")
    loaded = top_level_modules(code)
    assert "ssd3d_torch" not in loaded and not loaded & set(FORBIDDEN)


def test_the_yardstick_loads_nothing_of_the_program():
    code = ("import json, sys\nimport portbench.rooflines, portbench.peaks, portbench.trace, "
            "portbench.scenes, portbench.weights, portbench.judge\n"
            "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")
    loaded = top_level_modules(code)
    assert "ssd3d_torch" not in loaded and not loaded & set(FORBIDDEN)
