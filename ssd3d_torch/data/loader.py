"""Host input pipeline: per-scan load + augment + point budget + batching.

The port's copy of `ssd3d/data/loader.py` (`KittiLoader`, `MixupDatabase`,
`budget_points`, `batches`), numpy only, with one repair: `batches` passes
`mp_method` through to its worker processes, where the reference drops it
and always forks. A process that has initialised CUDA must not fork, so the
port's trainer asks for "forkserver" on every device. Under data
parallelism the trainer sets `row_range = (lo, hi)`: each batch of the
deterministic global stream then holds only its rows [lo, hi), the rows
this rank trains on, and only those are loaded.

Each sample is a pure function of (epoch seed, sample index), so any batch
is reproducible regardless of worker scheduling, and delivery is in
sequence order. Batches are fixed-shape: points padded/sampled to
POINTS_NUM_FOR_TRAINING and GT tensors zero-padded to a static cap.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue
import threading

import numpy as np

from ssd3d_torch.data.augment import Augmentor
from ssd3d_torch.data.kitti_io import KittiScene

MAX_GT = 64  # static GT cap; KITTI scenes top out far below this after mixup


def _collate(samples):
    keys = [k for k in samples[0] if k != "name"]
    batch = {k: np.stack([s[k] for s in samples]) for k in keys}
    batch["names"] = np.asarray([s["name"] for s in samples])
    return batch


def _collate_block(loader, block):
    """Load + collate one batch's (epoch, index) block, or with the
    loader's `row_range = (lo, hi)` set only its rows [lo, hi)."""
    if loader.row_range is not None:
        block = block[loader.row_range[0]:loader.row_range[1]]
    return _collate([loader.load_sample(i, epoch_seed=e) for e, i in block])


def _mp_worker(loader_bytes, task_q, out_q):
    """Worker-process loop: pull an (epoch, index) block, emit a collated
    batch. The loader is rebuilt from a pickle so 'spawn' contexts work too."""
    # A fork-child inherits its parent's SIGTERM/SIGINT Python handlers but
    # not its helper threads — such a handler may never run, so terminate()
    # would not kill the worker and the parent's exit-time join would hang.
    # Restore kernel-default dispositions first.
    import signal

    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    signal.signal(signal.SIGINT, signal.SIG_DFL)
    try:
        loader = pickle.loads(loader_bytes)
        while True:
            idxs = task_q.get()
            if idxs is None:
                out_q.put(None)
                return
            seq, block = idxs
            out_q.put((seq, _collate_block(loader, block)))
    except BaseException as exc:  # surface worker crashes in the parent
        import traceback

        out_q.put(RuntimeError(
            f"loader worker failed: {exc!r}\n{traceback.format_exc()}"))


class MixupDatabase:
    """Per-class GT-crop sampler (builder/mixup_sampler.py).

    The reference cycles a shuffled cursor through each class DB
    (mixup_sampler.py round-robin); a cursor is *shared mutable state*,
    which would make sample content depend on worker scheduling and break
    both run-to-run reproducibility and multi-host training (every process
    must materialize the identical global batch, trainer._device_batch).
    Instead each draw is a pure function of the caller's per-sample rng —
    uniform without replacement, which matches the round-robin's uniform
    coverage in expectation at GT-database sizes (thousands of crops)."""

    def __init__(self, root: str, cls_list, num_list, cls2idx, seed: int = 0):
        self.entries = {}
        self.cls_list = list(cls_list)
        self.num_list = list(num_list)
        self.cls2idx = cls2idx
        for cls in self.cls_list:
            cls_dir = os.path.join(root, cls)
            with open(os.path.join(cls_dir, "list.txt")) as f:
                names = [line.strip() for line in f if line.strip()]
            self.entries[cls] = [
                os.path.join(cls_dir, f"{n}.npz") for n in names
            ]

    def _draw(self, rng, cls, num):
        n = len(self.entries[cls])
        return rng.choice(n, size=num, replace=num > n)

    def sample(self, rng):
        boxes, classes, points = [], [], []
        for cls, num in zip(self.cls_list, self.num_list):
            for i in self._draw(rng, cls, num):
                data = np.load(self.entries[cls][i])
                boxes.append(data["box_3d"])
                classes.append(self.cls2idx[cls])
                points.append(data["points"])
        return np.stack(boxes), np.asarray(classes, np.int32), points


def budget_points(rng: np.random.Generator, points, sem_labels, sem_dists,
                  target: int):
    """Random sample to exactly `target` points; oversample WITHOUT
    replacement first, then pad WITH replacement
    (kitti_dataloader.py:137-151)."""
    n = len(points)
    if n >= target:
        sel = rng.choice(n, target, replace=False)
    else:
        sel = np.concatenate(
            [rng.permutation(n), rng.choice(n, target - n, replace=True)]
        )
    return points[sel], sem_labels[sel], sem_dists[sel]


class KittiLoader:
    """Loads preprocessed .npz scans, augments (train), budgets points, and
    emits fixed-shape batches. With `device_aug` the host augments nothing
    and emits the road plane and GT-crop candidates for the train step's
    augmentation on the device instead."""

    CAND_POINTS = 512  # fixed per-crop point cap for pasting on the device

    def __init__(self, cfg, split: str, data_dir: str | None = None,
                 training: bool = True, seed: int = 0,
                 mixup_db: MixupDatabase | None = None,
                 device_aug: bool = False):
        self.device_aug = device_aug and training
        kcfg = cfg.DATASET.KITTI
        self.cfg = cfg
        self.training = training
        self.seed = seed
        self.row_range: tuple[int, int] | None = None  # this rank's rows of each batch
        self.points_num = cfg.MODEL.POINTS_NUM_FOR_TRAINING
        self.data_dir = data_dir or os.path.join(kcfg.SAVE_NUMPY_PATH, split)
        with open(os.path.join(self.data_dir, "list.txt")) as f:
            self.names = [line.strip() for line in f if line.strip()]
        if training and cfg.TRAIN.AUGMENTATIONS.MIXUP.OPEN and mixup_db is None:
            cls2idx = {c: i + 1 for i, c in enumerate(kcfg.CLS_LIST)}
            mixup_db = MixupDatabase(
                os.path.join(kcfg.SAVE_NUMPY_PATH,
                             cfg.TRAIN.AUGMENTATIONS.MIXUP.SAVE_NUMPY_PATH,
                             cfg.TRAIN.AUGMENTATIONS.MIXUP.PC_LIST),
                cfg.TRAIN.AUGMENTATIONS.MIXUP.CLASS,
                cfg.TRAIN.AUGMENTATIONS.MIXUP.NUMBER,
                cls2idx, seed=seed,
            )
        self.mixup_db = mixup_db if (training and cfg.TRAIN.AUGMENTATIONS.MIXUP.OPEN) else None
        self.augmentor = (
            Augmentor(cfg, mixup_db) if (training and not self.device_aug) else None
        )
        self.scene = (
            KittiScene(kcfg.BASE_DIR_PATH, "training") if training else None
        )

    def __len__(self):
        return len(self.names)

    @property
    def sample_points_shape(self) -> tuple:
        """(points per scan, feature channels) of emitted batches."""
        return (self.points_num, 4)

    def load_sample(self, index: int, epoch_seed: int = 0) -> dict:
        """Deterministic function of (epoch_seed, index)."""
        name = self.names[index]
        data = np.load(os.path.join(self.data_dir, f"{name}.npz"))
        points = data["points"]
        sem_labels = data["sem_labels"]
        sem_dists = data["sem_dists"]
        boxes = data["boxes_3d"] if "boxes_3d" in data else np.zeros((1, 7), np.float32)
        classes = data["classes"] if "classes" in data else np.zeros((1,), np.int32)

        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch_seed, int(name)])
        )
        extras = {}
        if self.training:
            try:
                plane = self.scene.plane(int(name))
            except FileNotFoundError:
                plane = np.array([0.0, -1.0, 0.0, 1.65])  # flat-road fallback
            if self.augmentor is not None:
                points, sem_labels, sem_dists, boxes, classes = self.augmentor(
                    rng, points, sem_labels, sem_dists, boxes, classes, plane
                )
            elif self.device_aug:
                extras = self._mixup_candidates(rng, plane)
        points, sem_labels, sem_dists = budget_points(
            rng, points, sem_labels, sem_dists, self.points_num
        )

        gt = np.zeros((MAX_GT, 7), np.float32)
        labels = np.zeros((MAX_GT,), np.int32)
        k = min(len(boxes), MAX_GT)
        gt[:k] = boxes[:k]
        labels[:k] = classes[:k]
        out = {
            "points": points.astype(np.float32),
            "sem_labels": sem_labels.astype(np.int32),
            "gt_boxes": gt,
            "gt_labels": labels,
            "calib_P2": data["calib_P2"].astype(np.float32),
            "image_size": (
                data["image_size"].astype(np.int32)
                if "image_size" in data
                else np.array([375, 1242], np.int32)
            ),
            "name": int(name),
        }
        out.update(extras)
        return out

    def _mixup_candidates(self, rng, plane):
        """Fixed-shape GT-crop candidates for pasting on the device
        (`train/device_aug.py`), with the road plane."""
        if self.mixup_db is None:
            return {"plane": plane.astype(np.float32)}
        boxes, classes, pts_list = self.mixup_db.sample(rng)
        # static candidate count: the round-robin sampler can return fewer
        # near the end of its permutation
        k = int(sum(self.mixup_db.num_list))
        p = self.CAND_POINTS
        cand = np.zeros((k, p, 4), np.float32)
        cand_boxes = np.zeros((k, 7), np.float32)
        cand_labels = np.zeros((k,), np.int32)
        valid = np.zeros((k,), bool)
        for i, pts in enumerate(pts_list[:k]):
            if len(pts) == 0:
                continue
            m = min(len(pts), p)
            cand[i, :] = pts[0, :4]  # pad by repeating the first point
            cand[i, :m] = pts[:m, :4]
            cand_boxes[i] = boxes[i]
            cand_labels[i] = classes[i]
            valid[i] = True
        return {
            "cand_points": cand,
            "cand_boxes": cand_boxes,
            "cand_labels": cand_labels,
            "cand_valid": valid,
            "plane": plane.astype(np.float32),
        }

    # ------------------------------------------------------------------
    def _index_stream(self, batch_size: int, epochs: int | None,
                      shuffle: bool):
        n = len(self.names)
        epoch = 0
        while epochs is None or epoch < epochs:
            order = np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch])
            ).permutation(n) if shuffle else np.arange(n)
            for i in order:
                yield epoch, int(i)
            epoch += 1

    def batches(self, batch_size: int, epochs: int | None = None,
                num_threads: int = 2, shuffle: bool | None = None,
                num_procs: int = 0, mp_method: str = "fork",
                start_iter: int = 0):
        """Yield stacked fixed-shape batches, prefetched.

        start_iter fast-forwards the (epoch, index) stream by that many
        BATCHES without loading anything, so a run resumed from a step-N
        checkpoint consumes exactly the batches the unkilled run would
        have seen at steps N+1, N+2, ... — resume is batch-exact, not
        merely optimizer-correct. (The reference restarts its ZMQ stream
        from scratch on restore.)

        num_procs=0 (default): thread workers — numpy releases the GIL for
        most of the augmentation math. num_procs>0: worker *processes* (the
        reference's ZMQ multiprocess pipeline, data_provider.py:265-404,
        minus the ZMQ — a pickled loader per worker over mp queues), started
        by `mp_method` ("fork", "spawn" or "forkserver"; a process that has
        initialised CUDA must not fork). Every sample is a pure function of
        (epoch, index) AND delivery is sequence-ordered (a reorder buffer at
        the consumer), so the batch at train iteration k is identical for
        any worker count, start method or scheduling.
        """
        shuffle = self.training if shuffle is None else shuffle
        stream = self._index_stream(batch_size, epochs, shuffle)
        for _ in range(start_iter * batch_size):  # pure index skip, no IO
            if next(stream, None) is None:
                break
        if num_procs > 0:
            yield from self._batches_mp(
                batch_size, stream, num_procs, mp_method)
            return

        lock = threading.Lock()
        seq_box = [0]
        out_q: queue.Queue = queue.Queue(maxsize=4)
        stop = threading.Event()

        def worker():
            try:
                while not stop.is_set():
                    with lock:
                        seq = seq_box[0]
                        try:
                            idxs = [next(stream) for _ in range(batch_size)]
                        except StopIteration:
                            out_q.put(None)
                            return
                        seq_box[0] += 1
                    out_q.put((seq, _collate_block(self, idxs)))
            except BaseException as exc:  # propagate instead of dying silently
                out_q.put(exc)

        threads = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(max(1, num_threads))
        ]
        for t in threads:
            t.start()
        finished = 0
        pending: dict = {}
        want = 0
        try:
            while finished < len(threads):
                item = out_q.get()
                if item is None:
                    finished += 1
                    continue
                if isinstance(item, BaseException):
                    raise item
                pending[item[0]] = item[1]
                while want in pending:  # deliver strictly in sequence order
                    yield pending.pop(want)
                    want += 1
        finally:
            stop.set()

    def _batches_mp(self, batch_size, stream, num_procs,
                    mp_method: str = "fork"):
        ctx = mp.get_context(mp_method)
        task_q = ctx.Queue(maxsize=2 * num_procs)
        out_q = ctx.Queue(maxsize=2 * num_procs)
        loader_bytes = pickle.dumps(self)
        procs = [
            ctx.Process(target=_mp_worker,
                        args=(loader_bytes, task_q, out_q), daemon=True)
            for _ in range(num_procs)
        ]
        for p in procs:
            p.start()

        def feeder():
            seq = 0
            while True:
                idxs = []
                for _ in range(batch_size):
                    try:
                        idxs.append(next(stream))
                    except StopIteration:
                        break
                if len(idxs) < batch_size:
                    for _ in procs:
                        task_q.put(None)
                    return
                task_q.put((seq, idxs))
                seq += 1

        feed_thread = threading.Thread(target=feeder, daemon=True)
        feed_thread.start()
        finished = 0
        pending: dict = {}
        want = 0
        try:
            while finished < len(procs):
                try:
                    item = out_q.get(timeout=5.0)
                except queue.Empty:
                    # a worker that died without reporting (segfault, OOM
                    # kill, or a clean os._exit(0) in a dependency) must not
                    # hang the trainer: the queue has been empty for 5 s, so
                    # every delivered sentinel is accounted for in
                    # `finished`; more dead workers than sentinels means a
                    # worker exited without reporting.
                    n_dead = sum(not p.is_alive() for p in procs)
                    if n_dead > finished:
                        codes = [p.exitcode for p in procs if not p.is_alive()]
                        raise RuntimeError(
                            "loader worker died without delivering its "
                            f"sentinel; exit code(s) {codes}")
                    continue
                if item is None:
                    finished += 1
                    continue
                if isinstance(item, BaseException):
                    raise item
                pending[item[0]] = item[1]
                while want in pending:  # deliver strictly in sequence order
                    yield pending.pop(want)
                    want += 1
        finally:
            for p in procs:
                p.terminate()
            for p in procs:
                p.join(timeout=5)
            for p in procs:  # escalate: never leave an unkillable child
                if p.is_alive():
                    p.kill()
                    p.join(timeout=5)
