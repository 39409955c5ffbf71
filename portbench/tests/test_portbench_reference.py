"""The plain reference against the program's CPU path at a shrunk size, on
the benchmark's seeded weights: at float32 the two compute the same
functions, so every layer agrees to float32 rounding and every pick and
detection is the same; and the weights the reference names load into the
program strictly (the two name every tensor alike)."""

from __future__ import annotations

import json
import re

import pytest
import torch

from types import SimpleNamespace

from portbench import harness, judge, loadgen, rooflines, variants, weights
from portbench.loops import offline
from portbench.reference import nets, poolers

CPU = torch.device("cpu")
# every configuration of the benchmark, tested the day its file lands
CONFIGS = [c["name"] for c in harness.benchmark()["configs"]]


def f32_config(name: str) -> tuple[dict, int]:
    conf = harness.load_config(name)
    cfg = variants.shrink_config(conf["cfg"], 8)
    cfg["TPU"]["COMPUTE_DTYPE"] = "float32"
    return cfg, conf["nms_pre_topk"]


def judged(cfg: dict, topk: int, det: nets.Detector, w: dict):
    """The program built from `cfg` with the weights `w`, one request of two
    seeded scans through it, judged by `det` -> (verdict, detections,
    scans)."""
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
    return v, dets, points


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_follows_the_program_at_f32(name):
    cfg, topk = f32_config(name)
    det = nets.Detector(cfg, topk)
    w = weights.make(det.spec, 7, CPU)
    v, dets, points = judged(cfg, topk, det, w)
    with torch.inference_mode():
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


def with_pooler(cfg: dict, kind: str) -> dict:
    cfg = json.loads(json.dumps(cfg))
    cfg["MODEL"]["NETWORK"]["FIRST_STAGE"]["POINTS_POOLER"][0] = kind
    return cfg


def test_a_pooler_type_is_a_file_of_its_own(tmp_path, monkeypatch):
    # a second pooler type, RegionPool's file under another name, in a folder
    # of its own: the reference, the weights, the judge and the counts take it
    # with no other file changed
    source = (poolers.HERE / "RegionPool.py").read_text()
    for kind in ("RegionPool", "CopiedPool"):
        (tmp_path / f"{kind}.py").write_text(source)
    monkeypatch.setattr(poolers, "HERE", tmp_path)
    cfg, topk = f32_config("pointrcnn_kitti_car")
    copied = with_pooler(cfg, "CopiedPool")
    det = nets.Detector(copied, topk)
    assert type(det.pooler).__module__ == "portbench_pooler_CopiedPool"
    assert det.spec == nets.Detector(cfg, topk).spec
    w = weights.make(det.spec, 7, CPU)
    # the program runs its own RegionPool, judged through the copy
    v, _, _ = judged(cfg, topk, det, w)
    assert v.layer_gap < 1e-5 and v.picks_off == 0 and v.dets_off == 0, (v.where, v.notes)
    assert judge.watched_modules(det) == judge.watched_modules(nets.Detector(cfg, topk))
    full = harness.load_config("pointrcnn_kitti_car")["cfg"]
    full_copied = with_pooler(full, "CopiedPool")
    assert rooflines.shapes(full_copied, 8) == rooflines.shapes(full, 8)
    assert rooflines.flops(full_copied, 8) == rooflines.flops(full, 8)


def test_a_pooler_with_no_file_names_the_file_to_add(tmp_path):
    cfg = with_pooler(harness.load_config("pointrcnn_kitti_car")["cfg"], "NoSuchPool")
    with pytest.raises(ValueError, match="add portbench/reference/poolers/NoSuchPool.py"):
        nets.Detector(cfg)
    with pytest.raises(ValueError, match="NoSuchPool.py"):
        rooflines.flops(cfg, 8)
    with pytest.raises(ValueError, match=re.escape(str(tmp_path / "NoSuchPool.py"))):
        poolers.load("NoSuchPool", tmp_path)
