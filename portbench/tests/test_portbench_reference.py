"""The plain reference against the program's CPU path at a shrunk size, on
the benchmark's seeded weights: at float32 the two compute the same
functions, so every layer agrees to float32 rounding and every pick and
detection is the same; and the weights the reference names load into the
program strictly (the two name every tensor alike)."""

from __future__ import annotations

import json

import pytest
import torch

from types import SimpleNamespace

from portbench import harness, judge, loadgen, variants, weights
from portbench.loops import offline
from portbench.reference import nets

CPU = torch.device("cpu")
CONFIGS = ["3dssd_kitti_car", "pointrcnn_kitti_car"]


def f32_config(name: str) -> tuple[dict, int]:
    conf = harness.load_config(name)
    cfg = variants.shrink_config(conf["cfg"], 8)
    cfg["TPU"]["COMPUTE_DTYPE"] = "float32"
    return cfg, conf["nms_pre_topk"]


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_follows_the_program_at_f32(name):
    cfg, topk = f32_config(name)
    det = nets.Detector(cfg, topk)
    w = weights.make(det.spec, 7, CPU)
    cell = SimpleNamespace(cfg=cfg, conf={"nms_pre_topk": topk}, mix={"judged": 1})
    prog = offline.PortProgram(SimpleNamespace(cell=cell, det=det, w=w, device=CPU, seed=7))
    rec = prog.recorder
    mix = {"pool": 2, "max_cars": 6}
    pool = loadgen.make_pool(mix, 7, cfg["MODEL"]["POINTS_NUM_FOR_TRAINING"], CPU)
    points = pool["points"]
    slot = rec.begin()
    dets = prog.infer(points)
    rec.end(slot, {})
    with torch.inference_mode():
        v = judge.judge_request(det, nets.Params(w, False), points, rec.kept[0]["outputs"], dets)
        ref = det.forward(nets.Params(w, False), points)
    assert v.layer_gap < 1e-5 and v.picks_off == 0 and v.dets_off == 0, (v.where, v.notes)
    for key in ("valid", "index", "classes"):
        assert torch.equal(dets[key].long(), ref[key].long()), key
    assert torch.allclose(dets["boxes"], ref["boxes"], rtol=1e-5, atol=1e-5)
    assert torch.allclose(dets["scores"], ref["scores"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", CONFIGS)
def test_weights_are_seeded_and_named_as_the_program_names_them(name):
    conf = harness.load_config(name)
    det = nets.Detector(conf["cfg"], conf["nms_pre_topk"])
    a, b = weights.make(det.spec, 3, CPU), weights.make(det.spec, 3, CPU)
    c = weights.make(det.spec, 4, CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a[det.spec[0][0]], c[det.spec[0][0]])
    from ssd3d_torch.config import Config
    from ssd3d_torch.models.api import build_pipeline
    model = build_pipeline(Config(json.loads(json.dumps(conf["cfg"]))), device=CPU).model
    assert set(model.state_dict()) == set(a)
    for key, val in model.state_dict().items():
        assert tuple(val.shape) == tuple(a[key].shape), key


def test_scan_pool_is_fixed_by_the_seed():
    mix = {"pool": 4, "max_cars": 6}
    a = loadgen.make_pool(mix, 2**31 + 5, 512, CPU)
    b = loadgen.make_pool(mix, 2**31 + 5, 512, CPU)
    c = loadgen.make_pool(mix, 2**31 + 6, 512, CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["points"], c["points"])
    assert a["points"].shape == (4, 512, 4)
