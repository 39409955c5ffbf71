"""Serving export (counterpart of `ssd3d/bin/export.py`): trace the
pipeline's inference with `torch.export` into one artifact, weights
included, that a serving process loads and calls without the config, the
model code or the checkpoint.

    python -m ssd3d_torch.bin.export --cfg <yaml> --log_dir runs/3dssd \
        [--out runs/3dssd/detector.pt2] [--batch 8] [--symbolic_batch] \
        [--restore_model_path <run, ckpt or step dir>] [--device cuda|cpu] \
        [KEY VALUE ...]

It restores the latest checkpoint under `<log_dir>/ckpt` (or
`--restore_model_path`), traces the module that `Pipeline.infer` runs
(`models.api.SingleStageInference` or `TwoStageInference`: forward,
decode and NMS; for PointRCNN and STD the RPN, the proposals, the chunked
RCNN and the final NMS), writes it with `torch.export.save` to
`<log_dir>/detector.pt2` and, beside it, `detector.pt2.json` with the
config, the checkpoint's step, the input shape ("b" for a symbolic
batch), the device, the class list and the artifact's bytes.

Load side:

    import torch, ssd3d_torch.ops          # registers torch.ops.ssd3d.*
    detector = torch.export.load(path).module()
    with torch.inference_mode():
        det = detector(points)   # {'boxes', 'scores', 'classes', 'valid', 'index', ...}

The artifact holds the port's kernels as the custom ops
`torch.ops.ssd3d.*` (`ops/library.py`), so the loading process imports
`ssd3d_torch.ops`, which registers them, and nothing else of the package:
not the models, the config or the checkpoint code. It serves on the
device it was exported on (the `.json`'s `device`): its constants live
there, and points on another device fail at its first operation.

`--symbolic_batch` exports with a symbolic leading dimension
(`torch.export.Dim("b")`), so one artifact serves every batch size; the
trace runs at batch 2 (a batch of 1 would be specialised).

The JAX exporter's `--platforms` (jax.export's lowering targets) and
`--allow_custom_calls` (its check against Pallas custom calls) have no
meaning here: the artifact runs where PyTorch runs, and its custom ops are
registered, not serialised.

"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from ssd3d_torch.bin import cli_device
from ssd3d_torch.config import load_cfg
from ssd3d_torch.models.api import build_pipeline
from ssd3d_torch.train.trainer import CheckpointManager, restore_from_path


def export_infer(pipeline, batch: int, n_points: int,
                 symbolic_batch: bool = False) -> torch.export.ExportedProgram:
    """`pipeline.inference` (its weights included) traced by `torch.export`
    on points [batch, n_points, 4] of the pipeline's device; with
    `symbolic_batch` the batch is `torch.export.Dim("b")`."""
    device = next(pipeline.inference.parameters()).device
    example = torch.zeros(max(batch, 2) if symbolic_batch else batch, n_points, 4,
                          device=device)
    dynamic = {"points": {0: torch.export.Dim("b", min=1)}} if symbolic_batch else None
    with torch.no_grad():
        return torch.export.export(pipeline.inference, (example,), dynamic_shapes=dynamic,
                                   strict=False)


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser(prog="python -m ssd3d_torch.bin.export")
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--log_dir", required=True)
    ap.add_argument("--out", default=None,
                    help="artifact path (default <log_dir>/detector.pt2)")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--symbolic_batch", action="store_true",
                    help="export with a symbolic batch dim (any batch size)")
    ap.add_argument("--restore_model_path", default=None,
                    help="checkpoint to embed (run dir, ckpt dir, or step "
                    "dir); defaults to the latest under --log_dir/ckpt")
    ap.add_argument("--device", default="cuda",
                    help="the device to export for and serve on: cuda (default) or cpu")
    ap.add_argument("opts", nargs="*", default=[])
    args = ap.parse_args(argv)
    device = cli_device(args.device)
    cfg = load_cfg(args.cfg, args.opts)
    pipeline = build_pipeline(cfg, device=device)
    n_points = cfg.MODEL.POINTS_NUM_FOR_TRAINING
    if args.restore_model_path:
        ckpt, step = restore_from_path(args.restore_model_path, map_location=device)
    else:
        ckpt, step = CheckpointManager(os.path.join(args.log_dir, "ckpt")).restore(
            map_location=device)
    if ckpt is None:
        raise FileNotFoundError(f"no checkpoint under {args.restore_model_path or args.log_dir}")
    pipeline.model.load_state_dict(ckpt["model"])

    t0 = time.perf_counter()
    exported = export_infer(pipeline, args.batch, n_points, args.symbolic_batch)
    trace_s = time.perf_counter() - t0
    out = args.out or os.path.join(args.log_dir, "detector.pt2")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    torch.export.save(exported, out)
    meta = {
        "cfg": os.path.abspath(args.cfg),
        "checkpoint_step": step,
        "input": ["b" if args.symbolic_batch else args.batch, n_points, 4],
        "device": str(device),
        "cls_list": list(pipeline.cls_list),
        "bytes": os.path.getsize(out),
        "trace_s": trace_s,
    }
    with open(out + ".json", "w") as f:
        json.dump(meta, f, indent=1)
    print(f"exported step {step} -> {out} ({meta['bytes'] / 1e6:.1f} MB, device {device}, "
          f"traced in {trace_s:.1f} s)")
    return meta


if __name__ == "__main__":
    main()
