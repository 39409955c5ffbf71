"""Reference TF-1 checkpoints in the port, without TensorFlow
(`ssd3d_torch/utils/tf_bundle.py`, `ssd3d_torch/utils/tf_checkpoint.py`):
the numpy reader of the V2 bundle against `tf.train.load_checkpoint` on
bundles TensorFlow wrote; `chip_smoke.py`'s bundle writer read back by
TensorFlow; and `--restore_tf_checkpoint` through the `Trainer`,
`bin.train` and `bin.evaluate` for a single- and a two-stage config
(`tests/test_torch_tf_checkpoint_jax.py` holds the converter and its name
maps to the JAX package's). The tests that need TensorFlow import it
inside."""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from ssd3d_torch.bin import evaluate as evaluate_cli
from ssd3d_torch.bin import preprocess as preprocess_cli
from ssd3d_torch.bin import train as train_cli
from ssd3d_torch.config import load_cfg
from ssd3d_torch.entry import init_weights
from ssd3d_torch.models.api import build_pipeline
from ssd3d_torch.train.trainer import CheckpointManager, Trainer
from ssd3d_torch.utils import synth, tf_bundle

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
TINY = CONFIGS / "kitti" / "3dssd" / "3dssd_tiny.yaml"
PRCNN_TINY = CONFIGS / "kitti" / "pointrcnn" / "pointrcnn_tiny_stage2.yaml"



def _tf():
    return pytest.importorskip("tensorflow")


def _save_with_tensorflow(tf, tensors: dict, ckpt_dir) -> str:
    """A V2 checkpoint of `tensors` written by TensorFlow's own Saver."""
    with tf.Graph().as_default(), tf.compat.v1.Session() as sess:
        tf_vars = [tf.compat.v1.get_variable(name, initializer=value)
                   for name, value in tensors.items()]
        sess.run(tf.compat.v1.global_variables_initializer())
        return tf.compat.v1.train.Saver(tf_vars).save(sess, os.path.join(str(ckpt_dir),
                                                                        "model.ckpt"))


def _assert_same_as_tensorflow(tf, path, names):
    ref, ours = tf.train.load_checkpoint(str(path)), tf_bundle.load_checkpoint(str(path))
    assert ours.get_variable_to_shape_map() == ref.get_variable_to_shape_map()
    assert set(ref.get_variable_to_shape_map()) == set(names)
    for name in names:
        want, got = np.asarray(ref.get_tensor(name)), ours.get_tensor(name)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def _mixed_tensors(n_many: int) -> dict:
    """Scalars, float32 / float64 / int32 / int64 leaves and `n_many`
    weights with reference-style names (several index blocks, many
    restart points)."""
    rng = np.random.RandomState(0)
    out = {"global_step": np.int64(1234), "lr": np.float32(2.5e-3),
           "layer1/conv0_0/weights": rng.randn(1, 4, 16).astype(np.float32),
           "layer1/conv0_0/bn/moving_mean": rng.randn(16).astype(np.float64),
           "layer1/counts": rng.randint(-9, 9, size=(3, 5)).astype(np.int32),
           "layer1/ids": rng.randint(0, 1 << 40, size=(7,)).astype(np.int64)}
    for i in range(n_many):
        out[f"layer{i % 9}/conv{i % 4}_{i % 3}/vote_layer_{i}/weights"] = (
            rng.randn(1, 1 + i % 5, 3).astype(np.float32))
    return out


def test_reader_equals_tensorflow_on_tensorflow_written_bundles(tmp_path):
    tf = _tf()
    tensors = _mixed_tensors(300)
    prefix = _save_with_tensorflow(tf, tensors, tmp_path)
    assert os.path.getsize(prefix + ".index") > 2 * 4096  # several data blocks
    _assert_same_as_tensorflow(tf, prefix, tensors)
    # a directory resolves through its checkpoint file
    assert tf_bundle.checkpoint_prefix(str(tmp_path)) == prefix
    _assert_same_as_tensorflow(tf, tmp_path, tensors)
    # a long tensor takes the vectorised crc32c
    big = {"big/weights": np.random.RandomState(1).randn(1, 512, 300).astype(np.float32)}
    prefix = _save_with_tensorflow(tf, big, tmp_path / "big")
    _assert_same_as_tensorflow(tf, prefix, big)


def test_crc32c_known_values():
    assert tf_bundle.crc32c(b"") == 0
    assert tf_bundle.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value
    data = np.random.RandomState(2).bytes(70_001)  # the lanes' path, a partial lane
    reg = 0xFFFFFFFF
    for b in data:
        reg = tf_bundle._TABLE_LIST[(reg ^ b) & 0xFF] ^ (reg >> 8)
    assert tf_bundle.crc32c(data) == reg ^ 0xFFFFFFFF


def test_reader_refuses_what_it_cannot_read(tmp_path):
    weights = np.arange(12, dtype=np.float32).reshape(1, 3, 4)
    good = chip_smoke.write_tf_checkpoint(str(tmp_path / "good"), "m", {"a/weights": weights})
    np.testing.assert_array_equal(tf_bundle.load_checkpoint(good).get_tensor("a/weights"),
                                  weights)
    # V1: one file without an .index
    (tmp_path / "v1").write_bytes(b"\0" * 64)
    with pytest.raises(ValueError, match="V1 checkpoint"):
        tf_bundle.load_checkpoint(str(tmp_path / "v1"))
    with pytest.raises(FileNotFoundError):
        tf_bundle.load_checkpoint(str(tmp_path / "absent"))
    # a flipped byte in the tensor's data fails its crc32c
    data = Path(good + ".data-00000-of-00001")
    raw = bytearray(data.read_bytes())
    raw[5] ^= 1
    data.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="fails its crc32c"):
        tf_bundle.load_checkpoint(good).get_tensor("a/weights")
    # a flipped byte in the index fails its block's crc32c
    index = Path(good + ".index")
    table = bytearray(index.read_bytes())
    table[3] ^= 1
    index.write_bytes(bytes(table))
    with pytest.raises(ValueError, match="fails its crc32c"):
        tf_bundle.load_checkpoint(good)
    # a compressed block (its type byte 1, its crc32c recomputed)
    other = chip_smoke.write_tf_checkpoint(str(tmp_path / "snappy"), "m", {"x": np.zeros(2)})
    index = Path(other + ".index")
    table = bytearray(index.read_bytes())
    end = _first_block_size(bytes(table))
    table[end] = 1
    table[end + 1:end + 5] = tf_bundle.mask_crc(
        tf_bundle.crc32c(bytes(table[:end + 1]))).to_bytes(4, "little")
    index.write_bytes(bytes(table))
    with pytest.raises(ValueError, match="compressed"):
        tf_bundle.load_checkpoint(other)


def _first_block_size(table: bytes) -> int:
    """The size of the index's first block (a data block at offset 0), from
    the index block's first handle."""
    footer = table[-48:]
    pos = tf_bundle._varint(footer, tf_bundle._varint(footer, 0)[1])[1]
    idx_off, pos = tf_bundle._varint(footer, pos)
    idx_size, _ = tf_bundle._varint(footer, pos)
    _, handle = next(tf_bundle._entries(table[idx_off:idx_off + idx_size]))
    off, p = tf_bundle._varint(handle, 0)
    assert off == 0
    return tf_bundle._varint(handle, p)[0]


def test_reader_refuses_other_dtypes_by_name(tmp_path):
    tf = _tf()
    prefix = _save_with_tensorflow(tf, {"flag": np.array([True, False]),
                                        "w": np.ones(3, np.float32)}, tmp_path)
    reader = tf_bundle.load_checkpoint(prefix)
    assert reader.get_variable_to_shape_map() == {"flag": [2], "w": [3]}
    with pytest.raises(ValueError, match="'flag' has TensorFlow dtype 10"):
        reader.get_tensor("flag")


def test_chip_smoke_writer_is_read_back_by_tensorflow(tmp_path):
    tf = _tf()
    tensors = _mixed_tensors(200)
    prefix = chip_smoke.write_tf_checkpoint(str(tmp_path), "model.ckpt-7", tensors)
    assert os.path.getsize(prefix + ".index") > 2 * 4096
    _assert_same_as_tensorflow(tf, prefix, tensors)
    _assert_same_as_tensorflow(tf, tmp_path, tensors)


@pytest.fixture(scope="module")
def kitti_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("tf_kitti")
    data = root / "kitti"
    synth.write_tree(str(data), n_train=2, n_val=2, n_points=2600, seed=5, k_max=3)
    opts = ["--device", "cpu", "DATASET.KITTI.BASE_DIR_PATH", str(data),
            "DATASET.KITTI.TRAIN_LIST", str(data / "train.txt"),
            "DATASET.KITTI.VAL_LIST", str(data / "val.txt"),
            "DATASET.KITTI.SAVE_NUMPY_PATH", str(root / "npz"),
            "TRAIN.CONFIG.BATCH_SIZE", "2", "TRAIN.CONFIG.GPU_NUM", "1",
            "TRAIN.CONFIG.SUMMARY_INTERVAL", "1", "DATA_LOADER.NUM_PROCS", "0",
            "TRAIN.AUGMENTATIONS.MIXUP.NUMBER", "(3, )"]
    for split in ("train", "val"):
        preprocess_cli.main(["--cfg", str(TINY), "--img_list", split] + opts)
    return opts


@pytest.mark.parametrize("path", [TINY, PRCNN_TINY], ids=lambda p: p.stem)
def test_restore_tf_checkpoint_in_trainer_train_and_evaluate(path, kitti_tree, tmp_path):
    """Seeded port weights written under reference names, then through
    `Trainer(restore_tf_checkpoint=...)` (it starts from them), one
    `bin.train` iteration, and `bin.evaluate`, whose results equal those of
    a port checkpoint of the same weights."""
    opts = kitti_tree
    cfg_opts = opts[2:] + (["TEST.TEST_MODE", "Recall"] if path == PRCNN_TINY else [])
    cfg = load_cfg(str(path), cfg_opts)
    source = build_pipeline(cfg, device="cpu")
    init_weights(source.model, 3)
    want = source.model.state_dict()
    tf_dir = str(tmp_path / "tf")
    chip_smoke.write_tf_checkpoint(tf_dir, "model.ckpt-1", chip_smoke.reference_tensors(cfg, want))

    state = Trainer(cfg, str(tmp_path / "init"), restore_tf_checkpoint=tf_dir,
                    device="cpu").init_or_restore()
    start = state.model.state_dict()
    assert all(torch.equal(start[k], want[k]) for k in want)

    run = tmp_path / "run"
    cli_opts = opts[:2] + cfg_opts
    train_cli.main(["--cfg", str(path), "--log_dir", str(run), "--restore_tf_checkpoint", tf_dir,
                    "--max_iterations", "1"] + cli_opts)
    assert f"TF checkpoint {tf_dir} converted (0 unmatched paths)" in (
        run / "log_train.txt").read_text()
    assert np.isfinite(json.loads((run / "metrics.jsonl").read_text())["total"])

    port = tmp_path / "port"
    CheckpointManager(str(port / "ckpt")).save(0, {"step": 0, "model": want})
    results = {}
    for flag, value, tag in (("--restore_tf_checkpoint", tf_dir, "tf_ckpt"),
                             ("--restore_model_path", str(port), "0")):
        log_dir = tmp_path / f"eval_{tag}"
        evaluate_cli.main(["--cfg", str(path), "--log_dir", str(log_dir), flag, value,
                           "--viz_scans", "0"] + cli_opts)
        results[tag] = json.loads((log_dir / f"eval_{tag}.json").read_text())
    assert results["tf_ckpt"] == results["0"]
