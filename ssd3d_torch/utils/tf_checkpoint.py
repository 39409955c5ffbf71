"""Reference TF-1 checkpoint -> the port's state dict (counterpart of
`ssd3d/utils/tf_checkpoint.py`), without TensorFlow.

The reference stores weights as TF1 variables named by nested variable scopes
(created in lib/utils/tf_util.py): `<layer_scope>/conv<i>_<j>/weights`,
`.../biases`, and contrib BatchNorm stats under `.../bn/{gamma, beta,
moving_mean, moving_variance}`. `convert_tf_checkpoint` reads such a
checkpoint with `utils.tf_bundle` (a numpy reader of TensorFlow's V2
format) and maps it onto the port's modules, so a model trained by the
upstream reference runs through the port (the SURVEY parity requirement:
"checkpoint-convertible weights").

`build_name_map` and `build_two_stage_name_map` are the JAX package's,
copied (the port imports nothing of it): flax path tuple -> TF variable
prefix, derived from the graph builders, not hand-listed:
    SA MLP       flax backbone/<scope>/mlp<i>/conv<j>   <- <scope>/conv<i>_<j>
    aggregation  flax backbone/<scope>/aggregation      <- <scope>/ensemble
    vote layer   flax backbone/<scope>/mlp/conv<i>      <- <scope>/vote_layer_<i>
                 flax backbone/<scope>/vote_offsets     <- <scope>/vote_offsets
    FP module    flax backbone/<scope>/mlp/conv<i>      <- <scope>/conv_<i>
    SSG-last     flax backbone/<scope>/mlp/conv<j>      <- <scope>/conv<j>
    heads        flax <head>/trunk/conv<i>              <- <scope>/conv1d_<i>
                 flax <head>/pred_*                     <- <scope>/pred_*
The port names its modules after the flax scopes, so a flax path joined by
dots is the port's module (`utils.convert`), and its leaves are
`conv.kernel` <- weights (squeezed from [1(, 1), in, out] to [in, out]),
`conv.bias` <- biases, `bn.scale` <- bn/gamma, `bn.bias` <- bn/beta,
`bn.mean` <- bn/moving_mean, `bn.var` <- bn/moving_variance.

Duplicate-scope handling mirrors the backbone's name deduplication: when a
YAML reuses a scope (legal in TF; e.g. 3dssd.yaml names two layers "vote"),
the module is `<scope>_<layer_idx>` while the TF variables live under the
raw scope (only one of the duplicates creates variables).
"""

from __future__ import annotations

import numpy as np
import torch

from ssd3d_torch.utils.tf_bundle import load_checkpoint

# the port's leaves of one mapped conv: (module suffix, TF suffix)
BN_LEAVES = (("bn.scale", "bn/gamma"), ("bn.bias", "bn/beta"),
             ("bn.mean", "bn/moving_mean"), ("bn.var", "bn/moving_variance"))


def _used_names(architecture):
    """Replay PointBackbone's scope deduplication: layer index -> flax name."""
    used = set()
    names = []
    for layer_i, spec in enumerate(architecture):
        scope = spec[12]
        name = scope if scope and scope not in used else f"{scope or 'layer'}_{layer_i}"
        used.add(name)
        names.append(name)
    return names


def build_name_map(cfg, stage: str = "FIRST_STAGE", backbone: str = "backbone",
                   head_prefix: str = "head"):
    """-> (param_map, stats_map): flax path tuple -> TF variable name prefix.

    Paths are relative to the variables root, e.g.
    ('params', 'backbone', 'layer1', 'mlp0', 'conv0')."""
    net_cfg = cfg.MODEL.NETWORK[stage]
    arch = net_cfg.ARCHITECTURE
    flax_names = _used_names(arch)
    conv_map: dict = {}

    for layer_i, spec in enumerate(arch):
        layer_type, scope = spec[11], spec[12]
        flax_name = flax_names[layer_i]
        if layer_type == "SA_Layer":
            radius_list, mlp_list = spec[2], spec[4]
            if not isinstance(radius_list, (list, tuple)) or not radius_list:
                continue  # gather-only layer: no variables
            for i, mlps in enumerate(mlp_list):
                for j in range(len(mlps)):
                    conv_map[(backbone, flax_name, f"mlp{i}", f"conv{j}")] = (
                        f"{scope}/conv{i}_{j}"
                    )
            if spec[15] != -1 and cfg.MODEL.NETWORK.AGGREGATION_SA_FEATURE:
                conv_map[(backbone, flax_name, "aggregation")] = f"{scope}/ensemble"
        elif layer_type == "Vote_Layer":
            for i in range(len(spec[4])):
                conv_map[(backbone, flax_name, "mlp", f"conv{i}")] = (
                    f"{scope}/vote_layer_{i}"
                )
            conv_map[(backbone, flax_name, "vote_offsets")] = f"{scope}/vote_offsets"
        elif layer_type == "FP_Layer":
            for i in range(len(spec[4])):
                conv_map[(backbone, flax_name, "mlp", f"conv{i}")] = (
                    f"{scope}/conv_{i}"
                )
        elif layer_type == "SA_Layer_SSG_Last":
            for j in range(len(spec[4])):
                conv_map[(backbone, flax_name, "mlp", f"conv{j}")] = (
                    f"{scope}/conv{j}"
                )

    for i, head in enumerate(net_cfg.HEAD):
        mlp, head_type, scope = head[3], head[5], head[6]
        flax_head = scope if scope else f"{head_prefix}{i}"

        def tf_name(sub, scope=scope):
            # an empty TF variable scope adds no prefix
            return f"{scope}/{sub}" if scope else sub

        for j in range(len(mlp)):
            conv_map[(flax_head, "trunk", f"conv{j}")] = tf_name(f"conv1d_{j}")
        if head_type == "Det":
            for sub in ("pred_cls_base", "pred_cls", "pred_reg_base", "pred_reg",
                        "pred_attr_base", "pred_attr", "pred_velo_base",
                        "pred_velo"):
                conv_map[(flax_head, sub)] = tf_name(sub)
        else:
            for sub in ("pred_iou_base", "pred_iou"):
                conv_map[(flax_head, sub)] = tf_name(sub)
    return conv_map


def build_two_stage_name_map(cfg):
    """Name map for the DoubleStage (PointRCNN/STD) model: both backbones
    under their flax module names, the RoI pooler's align/vfe MLPs
    (reference pool_utils.py:5 scoping — `<pool_scope>/conv%d` and
    `<pool_scope>/vfe/conv%d`, points_pooler.py:101-114), and both head
    stacks."""
    conv_map = build_name_map(
        cfg, "FIRST_STAGE", backbone="rpn_backbone", head_prefix="rpn_head"
    )
    conv_map.update(build_name_map(
        cfg, "SECOND_STAGE", backbone="rcnn_backbone", head_prefix="rcnn_head"
    ))
    pc = cfg.MODEL.NETWORK.FIRST_STAGE.POINTS_POOLER
    pool_type, align_channels, scope = pc[0], pc[2], pc[8]
    flax_pool = scope or "roi_pool"

    def tf_name(sub):
        return f"{scope}/{sub}" if scope else sub

    for i in range(len(align_channels)):
        conv_map[(flax_pool, "align", f"conv{i}")] = tf_name(f"conv{i}")
    if pool_type == "PointsPool":
        for i in range(len(pc[6])):
            conv_map[(flax_pool, "vfe", f"conv{i}")] = tf_name(f"vfe/conv{i}")
    return conv_map


def convert_tf_checkpoint(ckpt_path: str, cfg, state_dict: dict, stage: str = "FIRST_STAGE",
                          strict: bool = False, log=print):
    """Load a reference TF checkpoint (a V2 prefix, or a directory with a
    `checkpoint` file) into a copy of the port's `state_dict`, each tensor
    in the dtype and on the device of the one it replaces. Single-stage
    configs map `stage`'s network; DoubleStage configs map both stages and
    the RoI pooler. -> (the new state dict, the unmatched flax conv paths);
    `strict` raises on any."""
    reader = load_checkpoint(ckpt_path)
    available = set(reader.get_variable_to_shape_map())
    if cfg.MODEL.TYPE == "DoubleStage":
        conv_map = build_two_stage_name_map(cfg)
    else:
        conv_map = build_name_map(cfg, stage)
    out = dict(state_dict)
    missing = []
    loaded = 0

    def put(key: str, value: np.ndarray) -> None:
        want = out[key]
        if tuple(want.shape) != value.shape:
            raise ValueError(f"convert_tf_checkpoint: {key} has shape {tuple(want.shape)}, "
                             f"the checkpoint {value.shape}")
        out[key] = torch.from_numpy(value.copy()).to(dtype=want.dtype, device=want.device)

    for path, tf_prefix in conv_map.items():
        module = ".".join(path)
        if f"{module}.conv.kernel" not in out:
            continue  # head variant not present in this model
        if f"{tf_prefix}/weights" not in available:
            missing.append("/".join(path))
            continue
        w = reader.get_tensor(f"{tf_prefix}/weights")
        put(f"{module}.conv.kernel", w.reshape(w.shape[-2], w.shape[-1]))  # [1(,1),in,out]
        if f"{tf_prefix}/biases" in available:
            put(f"{module}.conv.bias", reader.get_tensor(f"{tf_prefix}/biases"))
        loaded += 1
        if f"{module}.bn.scale" in out and f"{tf_prefix}/bn/gamma" in available:
            for leaf, tf_leaf in BN_LEAVES:
                put(f"{module}.{leaf}", reader.get_tensor(f"{tf_prefix}/{tf_leaf}"))

    if missing:
        log(f"checkpoint conversion: {loaded} convs loaded, "
            f"{len(missing)} unmatched: {missing[:8]}")
        if strict:
            raise KeyError(f"unmatched flax paths: {missing}")
    return out, missing
