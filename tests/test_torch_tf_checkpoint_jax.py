"""The port's reference-checkpoint converter (`ssd3d_torch/utils/
tf_checkpoint.py`) against the JAX package's (`ssd3d/utils/tf_checkpoint.py`):
the copied name maps equal the originals on every shipped config, and both
converters give the same weights, leaf for leaf, from one fabricated
checkpoint. JAX and TensorFlow are imported inside the tests."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from ssd3d_torch.config import load_cfg
from ssd3d_torch.models.api import build_pipeline
from ssd3d_torch.utils import tf_checkpoint

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
TINY = CONFIGS / "kitti" / "3dssd" / "3dssd_tiny.yaml"
PRCNN_TINY = CONFIGS / "kitti" / "pointrcnn" / "pointrcnn_tiny_stage2.yaml"
NAME_MAP_CONFIGS = [CONFIGS / p for p in (
    "kitti/3dssd/3dssd.yaml", "kitti/3dssd/3dssd_tiny.yaml", "kitti/3dssd/3dssd_3cls.yaml",
    "nuscenes/3dssd/3dssd.yaml", "nuscenes/3dssd/3dssd_tiny.yaml",
    "kitti/pointrcnn/pointrcnn_test.yaml", "kitti/pointrcnn/pointrcnn_stage1.yaml",
    "kitti/pointrcnn/pointrcnn_stage2.yaml", "kitti/pointrcnn/pointrcnn_tiny_stage1.yaml",
    "kitti/pointrcnn/pointrcnn_tiny_stage2.yaml", "kitti/std/std.yaml",
    "kitti/std/std_stage2.yaml")]


def _tf():
    return pytest.importorskip("tensorflow")


@pytest.mark.parametrize("path", NAME_MAP_CONFIGS, ids=lambda p: p.stem)
def test_name_maps_equal_the_jax_originals(path):
    pytest.importorskip("jax")
    from ssd3d.config import load_cfg as jax_load_cfg
    from ssd3d.utils import tf_checkpoint as jax_tf_checkpoint

    cfg, jcfg = load_cfg(str(path)), jax_load_cfg(str(path))
    if cfg.MODEL.TYPE == "DoubleStage":
        assert (tf_checkpoint.build_two_stage_name_map(cfg)
                == jax_tf_checkpoint.build_two_stage_name_map(jcfg))
    for stage in ("FIRST_STAGE", "SECOND_STAGE") if cfg.MODEL.TYPE == "DoubleStage" else (
            "FIRST_STAGE",):
        assert (tf_checkpoint.build_name_map(cfg, stage)
                == jax_tf_checkpoint.build_name_map(jcfg, stage)), stage


@pytest.mark.parametrize("path", [TINY, CONFIGS / "kitti/pointrcnn/pointrcnn_tiny_stage1.yaml",
                                  PRCNN_TINY, CONFIGS / "kitti/std/std.yaml",
                                  CONFIGS / "kitti/std/std_stage2.yaml"], ids=lambda p: p.stem)
def test_converter_equals_the_jax_converter(path, tmp_path):
    """A checkpoint fabricated with reference names for every mapped conv
    (the JAX package's own test helper, through TensorFlow) converted by
    both packages from the same seeded flax variables: every leaf of the
    port's state dict bit for bit the JAX result's through
    `flax_to_state_dict`."""
    jax = pytest.importorskip("jax")
    _tf()
    import flax
    import jax.numpy as jnp

    from ssd3d.config import load_cfg as jax_load_cfg
    from ssd3d.models import build_detector as jax_build_detector
    from ssd3d.models.two_stage import build_two_stage as jax_build_two_stage
    from ssd3d.utils import tf_checkpoint as jax_tf_checkpoint
    from ssd3d_torch.utils.convert import flax_to_state_dict
    from test_tf_checkpoint import _fabricate_ckpt
    from test_torch_model import _fill

    jcfg = jax_load_cfg(str(path))
    pts = jnp.zeros((1, 1024, 4), jnp.float32)
    key = jax.random.PRNGKey(0)
    if jcfg.MODEL.TYPE == "DoubleStage":
        model, rpn_spec, _ = jax_build_two_stage(jcfg, nms_pre_topk=256)
        shapes = jax.eval_shape(lambda: model.init(key, pts, False, 0.9, rpn_spec=rpn_spec))
        conv_map = jax_tf_checkpoint.build_two_stage_name_map(jcfg)
    else:
        model, _ = jax_build_detector(jcfg)
        shapes = jax.eval_shape(lambda: model.init(key, pts, False))
        conv_map = jax_tf_checkpoint.build_name_map(jcfg)
    variables = _fill(shapes, 9)
    flat = flax.traverse_util.flatten_dict(variables["params"])
    ckpt, _ = _fabricate_ckpt(conv_map, flat, tmp_path)
    jax_vars, jax_missing = jax_tf_checkpoint.convert_tf_checkpoint(ckpt, jcfg, variables,
                                                                    log=lambda *_: None)
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jax_vars))

    start = flax_to_state_dict(variables)
    got, missing = tf_checkpoint.convert_tf_checkpoint(ckpt, load_cfg(str(path)), start,
                                                       log=lambda *_: None)
    assert missing == jax_missing == []
    assert set(got) == set(want)
    changed = 0
    for k in want:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k]), k
        changed += not torch.equal(got[k], start[k])
    assert changed == len(want)  # every leaf came from the checkpoint
    # the converted state dict loads strictly into the port's model
    build_pipeline(load_cfg(str(path)), device="cpu").model.load_state_dict(got, strict=True)
