"""Where STD's stage-2 corner loss parts from the float64 JAX step (ROADMAP
Queue 3 item n): a probe, not a test (pytest collects only test_*.py).

    python tests/probe_std_corner_loss.py

It runs `tests/test_torch_std.py`'s stage-2 step (`std_step`: the tiny STD
config, f32, one step from a shared state, held to the JAX step run in
float64 with the f32 step's lattice) once as the test runs it and once for
each probe, and prints how far each loss of the port's f32 step lies from
the float64 step, as a share of the largest loss:

- `canonical`: the float64 step's pooler takes the canonical points the f32
  step computes (`canonicalize_pool` in f32), so both vote the same voxels;
- `bins`: the float64 step's Bin-Anchor decode takes the port's x and z
  bins (the argmax of its logits);
- `corner64`: the port's corner loss computed in float64 from its own f32
  inputs;
- `two_pass`: the port's train-mode BatchNorm takes the batch variance in
  two passes, mean((x - mean)^2), in place of mean(x^2) - mean^2 (both
  packages' formula); it also prints the largest relative error of the
  one-pass variance at each layer shape.

Nothing in the JAX package or the port is changed on disk.
"""

from __future__ import annotations

import contextlib
import sys
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import conftest  # noqa: E402,F401  (JAX on the CPU)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import test_torch_std as tstd  # noqa: E402
import test_torch_two_stage_train as tiny  # noqa: E402
from ssd3d.core import box_coders as jcoders  # noqa: E402
from ssd3d.models import two_stage as jtwo_stage  # noqa: E402
from ssd3d_torch.core import box_coders as tcoders  # noqa: E402
from ssd3d_torch.entry import synthetic_scenes  # noqa: E402
from ssd3d_torch.nn import layers  # noqa: E402
from ssd3d_torch.train import losses as tlosses  # noqa: E402

ONE_PASS_ERROR: dict = {}


def _canonical_f32(real):
    def canonical(pool_xyz, boxes):
        return real(pool_xyz.astype(jnp.float32), boxes.astype(jnp.float32)).astype(pool_xyz.dtype)
    return canonical


def _bins(port_calls: list):
    """The port's decode recorded, and the float64 JAX decode fed the
    port's x and z bins as one-hot logits (its argmax reads nothing else)."""
    real_t, real_j = tcoders.decode_bin_anchor, jcoders.decode_bin_anchor

    def port(det_offset, *args):
        port_calls.append(det_offset.detach().clone())
        return real_t(det_offset, *args)

    def jax_side(det_offset, det_angle_cls, det_angle_res, anchors, num_angle_cls, half_range,
                 num_bins):
        if det_offset.dtype == jnp.float64:
            rec = [c for c in port_calls if tuple(c.shape) == tuple(det_offset.shape)][-1].numpy()
            nb = num_bins
            for lo in (0, 2 * nb):
                onehot = jax.nn.one_hot(jnp.asarray(rec[..., lo:lo + nb].argmax(-1)), nb,
                                        dtype=det_offset.dtype)
                det_offset = det_offset.at[..., lo:lo + nb].set(onehot)
        return real_j(det_offset, det_angle_cls, det_angle_res, anchors, num_angle_cls,
                      half_range, num_bins)

    return port, jax_side


def _corner64(real):
    def corner(cfg, pred, targets):
        t64 = dict(targets, pmask=targets["pmask"].double(), gt_boxes=targets["gt_boxes"].double())
        return real(cfg, pred.double(), t64).float()
    return corner


def _two_pass(self, x, bn_momentum=0.9):
    """layers.BatchNorm.forward with the variance taken in two passes."""
    x = x.float()
    if self.training:
        dims = tuple(range(x.dim() - 1))
        mean = x.mean(dims)
        var = ((x - mean) ** 2).mean(dims)
        with torch.no_grad():
            one_pass = ((x * x).mean(dims) - mean * mean).clamp(min=0.0)
            key = tuple(x.shape)
            ONE_PASS_ERROR[key] = max(ONE_PASS_ERROR.get(key, 0.0), float(
                ((one_pass - var).abs() / var.clamp(min=1e-30)).max()))
            m = torch.as_tensor(bn_momentum, dtype=torch.float32)
            self.mean.copy_(m * self.mean + (1.0 - m) * mean)
            self.var.copy_(m * self.var + (1.0 - m) * var)
    else:
        mean, var = self.mean, self.var
    inv = torch.rsqrt(var + self.epsilon) * self.scale
    return x * inv + (self.bias - mean * inv)


def gaps(run: dict) -> dict:
    want, got = run["ref"][2], run["metrics"]
    keys = [k for k in want if k.startswith("loss_stage")]
    largest = max(abs(float(want[k])) for k in keys)
    return {k: abs(got[k] - float(want[k])) / largest for k in keys}


def main() -> None:
    data = synthetic_scenes(tiny.BATCH, 2048, seed=5)
    calls: list = []
    port_bins, jax_bins = _bins(calls)
    probes = {
        "as the test runs it": [],
        "canonical": [mock.patch.object(jtwo_stage, "canonicalize_pool",
                                        _canonical_f32(jtwo_stage.canonicalize_pool))],
        "bins": [mock.patch.object(tcoders, "decode_bin_anchor", port_bins),
                 mock.patch.object(jcoders, "decode_bin_anchor", jax_bins)],
        "corner64": [mock.patch.object(tlosses, "corner_loss", _corner64(tlosses.corner_loss))],
        "two_pass": [mock.patch.object(layers.BatchNorm, "forward", _two_pass)],
    }
    for name, patches in probes.items():
        with contextlib.ExitStack() as stack:
            for p in patches:
                stack.enter_context(p)
            run = tiny.stage_run(2, data, tstd.STD_STEP_OPTS, f32_lattice=True)
        row = gaps(run)
        print(f"{name}: " + ", ".join(f"{k.split('/', 1)[1]}{k[10]} {v:.3g}"
                                      for k, v in row.items()), flush=True)
    for shape, err in sorted(ONE_PASS_ERROR.items(), key=lambda kv: -kv[1])[:4]:
        print(f"one-pass variance, largest relative error at input {list(shape)}: {err:.3g}")


if __name__ == "__main__":
    main()
