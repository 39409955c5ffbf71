"""Config system: a nested attribute dict + YAML/CLI merging.

The port's own copy of `ssd3d/config/config.py` (same keys, defaults and
merge rules), so that `ssd3d_torch` imports nothing of the JAX package. Both
loaders return attribute-access dicts of the same tree, and the port's
modules take either. `tests/test_torch_config.py` holds the two to the same
tree for every YAML under `configs/`.

Keeps the exact YAML surface of the reference framework (lib/core/config.py in
dvlab-research/3DSSD) so its shipped configs — e.g. configs/kitti/3dssd/3dssd.yaml —
load unmodified. Unlike the reference this is NOT a process-global singleton:
`load_cfg` returns a config object that is passed explicitly (dependency
injection), and configs are hashable/freezable so they can parameterize jitted
functions safely.

The option space (keys + defaults) mirrors the reference's documented schema:
- backbone architecture DSL: 16-field layer tuples (reference config.py:207-239)
- head schema: 7-field tuples (reference config.py:241-250)
- pooler schema (reference config.py:252-264)
"""

from __future__ import annotations

import copy
import math
from ast import literal_eval
from typing import Any

import yaml


class Config(dict):
    """Nested dict with attribute access and optional immutability."""

    _FROZEN_KEY = "__frozen__"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        object.__setattr__(self, "_frozen", False)
        for k, v in list(self.items()):
            if isinstance(v, dict) and not isinstance(v, Config):
                self[k] = Config(v)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as exc:
            raise AttributeError(name) from exc

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, "_frozen"):
            raise AttributeError(f"Config is frozen; cannot set {name!r}")
        self[name] = value

    def __setitem__(self, key, value):
        if object.__getattribute__(self, "_frozen"):
            raise AttributeError(f"Config is frozen; cannot set {key!r}")
        if isinstance(value, dict) and not isinstance(value, Config):
            value = Config(value)
        super().__setitem__(key, value)

    def freeze(self, frozen: bool = True) -> "Config":
        object.__setattr__(self, "_frozen", frozen)
        for v in self.values():
            if isinstance(v, Config):
                v.freeze(frozen)
        return self

    def __reduce__(self):
        # dict-subclass pickling bypasses __init__, so __setitem__ would run
        # before `_frozen` exists; rebuild through the constructor instead
        # (needed by the multiprocess loader, which ships a pickled loader).
        return (
            _rebuild_config,
            (self.to_dict(), object.__getattribute__(self, "_frozen")),
        )

    def clone(self) -> "Config":
        out = Config()
        for k, v in self.items():
            out[k] = v.clone() if isinstance(v, Config) else copy.deepcopy(v)
        return out

    def to_dict(self) -> dict:
        return {
            k: (v.to_dict() if isinstance(v, Config) else v) for k, v in self.items()
        }


def _rebuild_config(d: dict, frozen: bool) -> "Config":
    c = Config(d)
    if frozen:
        c.freeze(True)
    return c


def get_default_cfg() -> Config:
    """Full default option tree (parity with reference lib/core/config.py)."""
    pi = math.pi
    c = Config()

    # ------------------------------------------------------------------ dataset
    c.DATASET = Config(
        TYPE="KITTI",  # KITTI | NuScenes | Lyft
        SELF_SPLIT_DATASET=False,
        POINT_CLOUD_RANGE=(-40, 40, -5, 3, 0, 70),
        VOXEL_SIZE=(0.2, 0.2, 0.2),
        MAX_NUMBER_OF_POINT_PER_VOXEL=100,
        MIN_POINTS_NUM=5,
        KITTI=Config(
            PREPROCESS_IMG_SIZE=(360, 1200),
            PREPROCESS_IMG_MEAN=[123.68, 116.779, 103.939],
            CLS_LIST=("Car", "Pedestrian", "Cyclist"),
            BASE_DIR_PATH="dataset/KITTI/object",
            TRAINVAL_LIST="dataset/KITTI/object/trainval.txt",
            TRAIN_LIST="dataset/KITTI/object/train.txt",
            VAL_LIST="dataset/KITTI/object/val.txt",
            TEST_LIST="dataset/KITTI/object/test.txt",
            SAVE_NUMPY_PATH="data/KITTI",
        ),
        NUSCENES=Config(
            BASE_DIR_PATH="data/NuScenes/raw",
            VERSION="v1.0-trainval",
            SAVE_NUMPY_PATH="data/NuScenes",
            VAL_SCENE_LIST="",  # official split file; empty = every 5th scene
            MAX_NUMBER_OF_VOXELS=32768,
            MAX_CUR_SAMPLE_POINTS_NUM=16384,
            NSWEEPS=10,
            INPUT_FEATURE_CHANNEL=4,
            # class/attribute lists used by the (rebuilt) nuScenes path
            CLS_LIST=(
                "car", "truck", "construction_vehicle", "bus", "trailer",
                "barrier", "motorcycle", "bicycle", "pedestrian", "traffic_cone",
            ),
        ),
    )

    # ------------------------------------------------------------------ training
    c.TRAIN = Config(
        AUGMENTATIONS=Config(
            OPEN=False,
            EXPAND_DIMS_LENGTH=0.1,
            PROB_TYPE="Simultaneously",  # Simultaneously | Seperately (sic, kept)
            PROB=[0.5, 0.5, 0.5],
            RANDOM_ROTATION_RANGE=45 / 180 * pi,
            RANDOM_SCALE_RANGE=0.1,
            FLIP=False,
            MIXUP=Config(
                OPEN=False,
                SAVE_NUMPY_PATH="mixup_database",
                PC_LIST="train",
                CLASS=("Car",),
                NUMBER=(15,),
            ),
            SINGLE_AUG=Config(
                ROTATION_PERTURB=[-pi / 3, pi / 3],
                CENTER_NOISE_STD=[1.0, 1.0, 0.0],
                RANDOM_SCALE_RANGE=[1.0, 1.0],
                SCALE_3_DIMS=False,
                FIX_LENGTH=False,
            ),
        ),
        CONFIG=Config(
            BATCH_SIZE=1,
            GPU_NUM=1,  # kept for config parity; maps to data-parallel device count
            MAX_ITERATIONS=500,
            CHECKPOINT_INTERVAL=50,
            MAX_CHECKPOINTS_TO_KEEP=10,
            SUMMARY_INTERVAL=10,
            # histogram summaries -> grad/param global norms in metrics.jsonl
            SUMMARY_HISTOGRAMS=True,
            # INERT (reference-dead too: the key is defined in the reference
            # config and never read; its trainer registers only scalar
            # summaries, trainer.py:80) — kept for YAML compatibility
            SUMMARY_IMG_IMAGES=True,
            # image summaries -> a BEV PNG per checkpoint in <log_dir>/bev/
            SUMMARY_BEV_IMAGES=True,
            TRAIN_PARAM_PREFIX=[],
            TRAIN_LOSS_PREFIX=[],
        ),
    )

    # NUM_PROCS -1 = auto: process workers for host-augmented training
    # (measured faster than threads there: benchmarks/bench_loader.py),
    # thread workers everywhere else; 0 = always threads; N>0 = N processes
    c.DATA_LOADER = Config(NUM_THREADS=4, NUM_PROCS=-1)

    # BATCH_SIZE is an ssd3d extension (reference eval is strictly batch-1):
    # >1 shards the eval forward's batch axis over all visible devices.
    # RCNN_INFER_CHUNK bounds two-stage inference HBM: the RCNN refines the
    # FIRST_STAGE.MAX_OUTPUT_NUM proposals in lax.map chunks of (the largest
    # divisor of the proposal count <=) this many at a time instead of
    # materializing the full [p, sample_pts, nsample, C] pooled-gather tensor
    # (e.g. 1000 proposals -> 2x ~11.7 GiB buffers on a 16 GiB chip).
    # 0 disables chunking.
    c.TEST = Config(WITH_GT=True, TEST_MODE="mAP", BATCH_SIZE=1,
                    RCNN_INFER_CHUNK=256)

    # ------------------------------------------------------------------ model
    def _stage_cfg(first_stage: bool) -> Config:
        return Config(
            TYPE="PointRCNN",  # PointRCNN | STD | 3DSSD
            MAX_OUTPUT_NUM=300 if first_stage else 100,
            NMS_THRESH=0.7,
            NUM_OBJECT_POINT=128 if first_stage else 512,
            MINIBATCH_NUM=64,
            MINIBATCH_RATIO=0.25,
            POINTS_SAMPLE_IOU=False,
            REGRESSION_METHOD=Config(
                TYPE="Dist-Anchor",  # Log-Anchor|Dist-Anchor|Dist-Anchor-free|Bin-Anchor
                HALF_BIN_SEARCH_RANGE=3.0,
                BIN_CLASS_NUM=12,
            ),
            # INERT (reference-dead too: never read outside config.py there;
            # the shipped configs never enable it) — kept for YAML parity
            REGRESSION_MULTI_HEAD=False,
            MULTI_HEAD_DISTRUBUTE=[
                ["car"], ["construction_vehicle", "truck"], ["bus", "trailer"],
                ["barrier"], ["motorcycle", "bicycle"], ["pedestrian", "traffic_cone"],
            ],
            CLS_ACTIVATION="Sigmoid",  # Sigmoid | Softmax
            ASSIGN_METHOD="IoU",  # IoU | Mask
            IOU_SAMPLE_TYPE="3D" if first_stage else "BEV",  # 3D | BEV | Point
            CLASSIFICATION_POS_IOU=0.7,
            CLASSIFICATION_NEG_IOU=0.55,
            CLASSIFICATION_LOSS=Config(
                TYPE="Center-ness",  # Center-ness | Is-Not | Focal-loss
                CENTER_NESS_LABEL_RANGE=(0.0, 1.0),
                SOFTMAX_SAMPLE_RANGE=10.0,
            ),
            CORNER_LOSS=False,
            PREDICT_ATTRIBUTE_AND_VELOCITY=False,
        )

    c.MODEL = Config(
        POINTS_NUM_FOR_TRAINING=16384,
        USING_ORIGIN_PLANE=False,
        TYPE="SingleStage",  # SingleStage | DoubleStage
        ONLY_FIRST_STAGE=False,
        PATH=Config(CHECKPOINT_DIR="log", EVALUATION_DIR="result"),
        BBOX_REG_WEIGHT=(1.0, 1.0, 1.0, 1.0, 1.0, 1.0),
        ENLARGE_ANCHORS_LENGTH=0.1,
        ANGLE_CLS_NUM=12,
        MAX_TRANSLATE_RANGE=[-3.0, -2.0, -3.0],
        NETWORK=Config(
            USE_BN=True,
            SYNC_BN=False,  # pmean-synced BN across the data mesh axis
            USE_GN=False,
            AGGREGATION_SA_FEATURE=False,
            ONLY_POS_DEFORMABLE_LOSS=False,
            FIRST_STAGE=Config(
                # 16-field layer tuples; schema documented in ssd3d/models/backbone.py
                ARCHITECTURE=[],
                HEAD=[[[6], [6], "conv1d", [128], True, "Det", "detection_head"]],
                POINTS_POOLER=[
                    "RegionPool", ["mask", "dist"], [128], 512, 1.0,
                    [6, 6, 6, 10], [128], True, "roi_pool",
                ],
                POOLER_MASK_THRESHOLD=0.5,
            ),
            SECOND_STAGE=Config(
                ARCHITECTURE=[],
                HEAD=[[[6], [6], "conv1d", [128], True, "Det", "detection_head"]],
            ),
        ),
        FIRST_STAGE=_stage_cfg(True),
        SECOND_STAGE=_stage_cfg(False),
    )

    # ------------------------------------------------------------------ solver
    c.SOLVER = Config(
        TYPE="SGD",  # SGD | Adam
        BASE_LR=0.001,
        BN_INIT_DECAY=0.5,
        BN_DECAY_DECAY_RATE=0.5,
        BN_DECAY_CLIP=0.99,
        LR_POLICY="step",
        GAMMA=0.1,
        STEP_SIZE=30000,
        STEPS=[],
        LRS=[],
        MAX_ITER=40000,
        MOMENTUM=0.9,
        # INERT (reference-dead too: SOLVER.WEIGHT_DECAY is defined at its
        # config.py:431 and read nowhere; per-layer weight_decay args are
        # passed as None throughout tf_util callers) — kept for YAML parity
        WEIGHT_DECAY=0.0005,
        BIAS_DOUBLE_LR=True,
        BIAS_WEIGHT_DECAY=False,
        WARM_UP_ITERS=500,
        WARM_UP_FACTOR=1.0 / 3.0,
        WARM_UP_METHOD="linear",
        SCALE_MOMENTUM=True,
        SCALE_MOMENTUM_THRESHOLD=1.1,
        LOG_LR_CHANGE_THRESHOLD=1.1,
    )

    # ------------------------------------------------------------------ TPU-native extras
    # New framework knobs with no reference counterpart live under TPU so that
    # reference YAMLs remain valid and the new surface is clearly separated.
    c.TPU = Config(
        MESH_SHAPE=Config(data=-1),  # -1: all visible devices on the data axis
        COMPUTE_DTYPE="float32",  # float32 | bfloat16 (activations/matmuls)
        NMS_PRE_TOPK=0,  # 0: use all candidate points; >0: score top-k prefilter
        DEVICE_AUGMENT=False,  # run the augmentation chain inside the train step
        DONATE_TRAIN_STATE=True,
        REMAT_SA_LAYERS=False,
        # dp: state replicated, batch sharded. fsdp: additionally shard
        # params + optimizer moments across the data axis (ZeRO-3 via
        # GSPMD; see parallel/mesh.py fsdp_shardings)
        PARALLEL_MODE="dp",
    )
    return c


# ----------------------------------------------------------------------------
# YAML / CLI merging (same strict-key, type-coerced semantics as the reference)
# ----------------------------------------------------------------------------

def _coerce(value_new: Any, value_old: Any, full_key: str) -> Any:
    """Coerce `value_new` to the type of `value_old` (strict, like reference
    config.py:617 _check_and_coerce_cfg_value_type)."""
    t_new, t_old = type(value_new), type(value_old)
    if t_new is t_old or value_old is None:
        return value_new
    # numeric promotion
    if isinstance(value_old, float) and isinstance(value_new, int):
        return float(value_new)
    if isinstance(value_old, tuple) and isinstance(value_new, list):
        return tuple(value_new)
    if isinstance(value_old, list) and isinstance(value_new, tuple):
        return list(value_new)
    if isinstance(value_old, str):
        return str(value_new)
    raise ValueError(
        f"Type mismatch ({t_old} vs {t_new}) for config key {full_key}: "
        f"{value_old!r} vs {value_new!r}"
    )


def _merge_into(base: Config, other: dict, stack: list) -> None:
    for key, value_new in other.items():
        full_key = ".".join(stack + [key])
        if key not in base:
            raise KeyError(f"Non-existent config key: {full_key}")
        value_old = base[key]
        if isinstance(value_old, Config) and isinstance(value_new, dict):
            _merge_into(value_old, value_new, stack + [key])
        else:
            base[key] = _coerce(_maybe_literal(value_new), value_old, full_key)


def _maybe_literal(v: Any) -> Any:
    """YAML leaves tuples like '(-40, 40)' as strings; literal_eval them."""
    if isinstance(v, str):
        try:
            return literal_eval(v)
        except (ValueError, SyntaxError):
            return v
    return v


def merge_cfg_from_file(cfg: Config, path: str) -> Config:
    with open(path) as f:
        loaded = yaml.safe_load(f)
    if loaded:
        _merge_into(cfg, loaded, [])
    return cfg


def merge_cfg_from_list(cfg: Config, opts: list) -> Config:
    """Merge `["KEY.SUBKEY", "value", ...]` pairs (reference config.py:525)."""
    assert len(opts) % 2 == 0, "opts must be key/value pairs"
    for full_key, v in zip(opts[0::2], opts[1::2]):
        keys = full_key.split(".")
        node = cfg
        for k in keys[:-1]:
            node = node[k]
        node[keys[-1]] = _coerce(_maybe_literal(v), node.get(keys[-1]), full_key)
    return cfg


def load_cfg(path: str | None = None, opts: list | None = None) -> Config:
    """Default tree + optional YAML file + optional CLI override pairs."""
    cfg = get_default_cfg()
    if path:
        merge_cfg_from_file(cfg, path)
    if opts:
        merge_cfg_from_list(cfg, opts)
    return cfg
