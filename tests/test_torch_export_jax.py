"""The port's exported program (`ssd3d_torch.bin.export.export_infer`)
against the JAX package's `export_infer` artifact (`ssd3d/bin/export.py`,
through `jax.export` serialize / deserialize) on the same flax weights and
points."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from ssd3d_torch.bin.export import export_infer
from ssd3d_torch.config import load_cfg
from ssd3d_torch.entry import synthetic_scenes
from ssd3d_torch.models.api import build_pipeline

TINY = Path(__file__).resolve().parents[1] / "configs" / "kitti" / "3dssd" / "3dssd_tiny.yaml"


def test_exported_program_equals_the_jax_artifact():
    """Same flax weights (seeded, BatchNorm statistics off their init) and
    points through the JAX package's `export_infer` artifact and the port's
    exported program, both at f32: classes and valid equal, boxes and scores
    within 1e-4 (the frameworks' matmuls sum in different orders, ~1e-6
    relative over the tiny model's layers), the same indices kept, in the
    same order but where two scores lie within 1e-5 of each other (NMS
    visits candidates by score: such a near-tie goes either way)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax import export as jexport

    from ssd3d.bin.export import export_infer as jax_export_infer
    from ssd3d.config import load_cfg as jax_load_cfg
    from ssd3d.models.api import build_pipeline as jax_build_pipeline
    from ssd3d_torch.utils.convert import flax_to_state_dict
    from test_torch_model import _fill

    opts = ["TPU.COMPUTE_DTYPE", "float32"]
    jcfg = jax_load_cfg(str(TINY), opts)
    n = jcfg.MODEL.POINTS_NUM_FOR_TRAINING
    jpipe = jax_build_pipeline(jcfg)
    state = jpipe.graph.init_state(jax.random.PRNGKey(0), jnp.zeros((1, n, 4), jnp.float32))
    variables = _fill({"params": state.params, "batch_stats": state.batch_stats}, 5)
    points = synthetic_scenes(2, n, seed=6)["points"]
    restored = jexport.deserialize(jax_export_infer(jpipe, variables, 2, n).serialize())
    want = {k: np.asarray(v) for k, v in restored.call(jnp.asarray(points)).items()}

    cfg = load_cfg(str(TINY), opts)
    pipe = build_pipeline(cfg, device="cpu")
    pipe.model.load_state_dict(flax_to_state_dict(variables), strict=True)
    served = export_infer(pipe, 2, n).module()
    with torch.inference_mode():
        got = {k: v.numpy() for k, v in served(torch.from_numpy(points)).items()}
    assert set(got) == set(want)
    for key in ("classes", "valid"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-4, atol=1e-4)
    # the same boxes kept; two of them may trade places in score order
    # where their scores lie within that tolerance of each other
    for b in range(2):
        valid = want["valid"][b]
        gi, wi = got["index"][b][valid], want["index"][b][valid]
        assert sorted(gi) == sorted(wi)
        swapped = gi != wi
        np.testing.assert_allclose(got["scores"][b][valid][swapped],
                                   want["scores"][b][valid][swapped], rtol=1e-5, atol=1e-6)
        by_index = dict(zip(wi.tolist(), want["boxes"][b][valid]))
        np.testing.assert_allclose(got["boxes"][b][valid], np.stack([by_index[i] for i in gi]),
                                   rtol=1e-4, atol=1e-4)
    assert int(got["valid"].sum()) > 0
