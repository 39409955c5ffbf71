"""Dataset dispatch (counterpart of `ssd3d/data/__init__.py`, the
reference's `choose_dataset`), config-driven by DATASET.TYPE. Returns a
constructed loader with the `batches(batch_size, num_threads=...,
num_procs=..., mp_method=...)` / `load_sample` / `augmentor` surface the
trainer and the evaluator consume. Host code: numpy, no torch.
"""

from __future__ import annotations


def build_loader(cfg, split: str, training: bool = True, seed: int = 0,
                 device_aug: bool = False, data_dir: str | None = None):
    dataset_type = cfg.DATASET.TYPE.upper()
    if device_aug and training:
        raise NotImplementedError(
            "build_loader: device augmentation (TPU.DEVICE_AUGMENT) is not ported yet "
            "(ROADMAP Queue 1 item 8a)")
    if dataset_type == "NUSCENES":
        raise NotImplementedError(
            "build_loader: nuScenes is not ported yet (ROADMAP Queue 1 item 11)")
    if dataset_type == "KITTI":
        from ssd3d_torch.data.loader import KittiLoader

        return KittiLoader(cfg, split, data_dir=data_dir, training=training, seed=seed)
    raise ValueError(f"unknown DATASET.TYPE {cfg.DATASET.TYPE!r}")
