"""K8, NMS's greedy keep sweep (`torch.ops.ssd3d.nms_keep`,
`ssd3d_torch/csrc/nms_keep.cu`).

On the CPU the op runs its plain version (`ops.nms.nms_keep_plain`), which
every NMS of the port sweeps through: `nms_bev`, `batched_class_nms`,
`class_unaware_nms` and `iou_guided_nms` are held to the JAX package's on the
same numpy inputs, at k in {1, 63, 64, 65, 300} (around a 64-bit word), with
everything suppressed, nothing suppressed, equal scores and random
overlaps; the kept sets (idx and valid with max_output past k) must be equal
exactly. The plain version is also held to a direct greedy loop in numpy,
and the op passes `torch.library.opcheck`. Tests marked `cuda` hold the
kernel to the plain version bit for bit on the card, at the same shapes, at
the proposal NMS's 2,048 candidates over 16 rows, around its tiles of 64
candidates with everything, nothing or a chain suppressed, past 65,535 rows,
and with a tile's rows staged in column chunks and its removed words in the
scratch (the test seam `nms._NMS_SMEM_BUDGET`); they skip without one.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd3d.core.iou import aabb_iou as jaabb_iou
from ssd3d.ops import nms as jnms
from ssd3d_torch.ops import _build, nms

KS = (1, 63, 64, 65, 300)
KINDS = ("random", "all", "none", "equal_scores")


def _t(a):
    return torch.from_numpy(np.array(a))


def _bev(kind: str, k: int, seed: int):
    """BEV rectangles [k, 4] and scores [k]: "all" the same box (the first
    visited suppresses the rest), "none" disjoint boxes on a grid, else
    random overlapping boxes; "equal_scores" gives every candidate one score
    (the stable sort visits them in index order)."""
    rng = np.random.RandomState(seed)
    if kind == "all":
        boxes = np.tile(np.array([[1.0, 1.0, 3.0, 4.0]]), (k, 1))
    elif kind == "none":
        g = np.arange(k)
        ctr = np.stack([g % 20 * 5.0, g // 20 * 5.0], -1)
        boxes = np.concatenate([ctr - 1.0, ctr + 1.0], -1)
    else:
        ctr = rng.uniform(0, 12, size=(k, 2))
        half = rng.uniform(0.5, 2.5, size=(k, 2))
        boxes = np.concatenate([ctr - half, ctr + half], -1)
    scores = rng.choice(np.linspace(0.05, 0.95, 12), size=k)
    if kind == "equal_scores":
        scores = np.full(k, 0.5)
    return boxes.astype(np.float32), scores.astype(np.float32)


def _equal(got, want, what=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=what)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", KS)
def test_nms_bev_keeps_jax_set(k, kind):
    boxes, scores = _bev(kind, k, 100 + k)
    wi, wv = jnms.nms_bev(jnp.asarray(boxes), jnp.asarray(scores), k + 3, 0.3)
    gi, gv = nms.nms_bev(_t(boxes), _t(scores), k + 3, 0.3)
    _equal(gv, wv, "valid")
    _equal(gi, wi, "idx")
    if kind == "all":
        assert int(gv.sum()) == 1
    if kind == "none":
        assert int(gv.sum()) == k


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", KS)
def test_batched_class_nms_keeps_jax_set(k, kind):
    b, cls = 2, 3
    rng = np.random.RandomState(200 + k)
    bev = np.stack([_bev(kind, k, 300 + 7 * i)[0] for i in range(b)])[:, :, None]  # reg_cls 1
    boxes3d = rng.uniform(-10, 10, size=(b, k, 1, 7)).astype(np.float32)
    scores = np.stack([np.stack([_bev(kind, k, 400 + 7 * i + c)[1] for c in range(cls)], -1)
                       for i in range(b)])
    want = jnms.batched_class_nms(jnp.asarray(boxes3d), jnp.asarray(bev), jnp.asarray(scores),
                                  k + 3, 0.1)
    got = nms.batched_class_nms(_t(boxes3d), _t(bev), _t(scores), k + 3, 0.1)
    assert set(got) == set(want)
    for key in want:
        _equal(got[key], want[key], key)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", KS)
def test_class_unaware_nms_keeps_jax_set(k, kind):
    b = 2
    rng = np.random.RandomState(500 + k)
    boxes = rng.uniform(1.0, 3.0, size=(b, k, 1, 7)).astype(np.float32)
    for i in range(b):
        bev, _ = _bev(kind, k, 600 + i)
        boxes[i, :, 0, 0] = (bev[:, 0] + bev[:, 2]) / 2  # x
        boxes[i, :, 0, 2] = (bev[:, 1] + bev[:, 3]) / 2  # z
        boxes[i, :, 0, 3] = bev[:, 2] - bev[:, 0]  # l
        boxes[i, :, 0, 5] = bev[:, 3] - bev[:, 1]  # w
        boxes[i, :, 0, 6] = 0.0
    scores = np.stack([_bev(kind, k, 700 + i)[1] for i in range(b)])[..., None]
    want = jnms.class_unaware_nms(jnp.asarray(boxes), jnp.asarray(scores), k + 3, 0.3)
    got = nms.class_unaware_nms(_t(boxes), _t(scores), k + 3, 0.3)
    for g, w, what in zip(got, want, ("boxes", "scores", "valid")):
        _equal(g, w, what)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", KS)
def test_iou_guided_nms_keeps_jax_set(k, kind):
    bev, scores = _bev(kind, k, 800 + k)
    iou = np.asarray(jaabb_iou(jnp.asarray(bev), jnp.asarray(bev)))
    iou_3d = np.random.RandomState(900 + k).choice([0.5, 1.0], size=k).astype(np.float32)
    want = jnms.iou_guided_nms(jnp.asarray(iou), jnp.asarray(scores), jnp.asarray(iou_3d),
                               k + 3, 0.1)
    got = nms.iou_guided_nms(_t(iou), _t(scores), _t(iou_3d), k + 3, 0.1)
    _equal(got[0], want[0], "idx")
    _equal(got[2], want[2], "valid")


def _greedy(suppress: np.ndarray) -> np.ndarray:
    """The sweep written out: visit j in order; keep j unless a kept i < j
    has suppress[i, j]."""
    r, k, _ = suppress.shape
    keep = np.zeros((r, k), bool)
    for row in range(r):
        for j in range(k):
            keep[row, j] = not any(keep[row, i] and suppress[row, i, j] for i in range(j))
    return keep


def _suppress(r: int, k: int, density: float, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).uniform(size=(r, k, k)) < density


@pytest.mark.parametrize("density", [0.0, 0.05, 0.5, 1.0])
@pytest.mark.parametrize("k", KS)
def test_plain_sweep_is_the_greedy_rule(k, density):
    """Entries on and below the diagonal are ignored: the matrix is random
    there too."""
    s = _suppress(3, k, density, k)
    keep = nms.nms_keep(_t(s))
    assert keep.dtype == torch.bool and keep.shape == (3, k)
    _equal(keep, _greedy(s))
    _equal(nms.nms_keep(torch.ones(2, k, k, dtype=torch.bool)),
           np.arange(k)[None].repeat(2, 0) == 0)  # all suppressed: the first stays
    assert bool(nms.nms_keep(torch.zeros(2, k, k, dtype=torch.bool)).all())


def test_op_passes_opcheck():
    s = _t(_suppress(3, 70, 0.2, 1))
    torch.library.opcheck(torch.ops.ssd3d.nms_keep, (s,))


# -------------------------------------------------- the kernel (needs the card)

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("density", [0.0, 0.02, 0.3, 1.0])
@pytest.mark.parametrize("r,k", [(3, 1), (3, 63), (3, 64), (3, 65), (5, 300), (80, 256),
                                 (16, 2048)])
def test_kernel_equals_plain(cuda, r, k, density):
    s = _t(_suppress(r, k, density, r * k))
    want = nms.nms_keep_plain(s)
    _build.reset_launches()
    got = nms.nms_keep(s.to(cuda))
    torch.cuda.synchronize()
    assert _build.launches()["nms_keep"] == 1
    assert got.dtype == torch.bool and torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", KS)
def test_kernel_equals_plain_on_nms_matrices(cuda, k, kind):
    """The suppress matrix `_nms_rows` sweeps: IoU over the threshold of the
    boxes in score order (made on the CPU, so both read the same booleans)."""
    boxes, scores = _bev(kind, k, 100 + k)
    order = torch.argsort(-_t(scores), stable=True)
    sorted_boxes = _t(boxes)[order][None]
    s = nms.aabb_iou(sorted_boxes, sorted_boxes) > 0.3
    assert torch.equal(nms.nms_keep(s.to(cuda)).cpu(), nms.nms_keep_plain(s))


def _patterned(r: int, k: int, kind: str) -> torch.Tensor:
    """suppress [r, k, k]: "all" (the first candidate suppresses the rest),
    "none", or "chain" (each candidate suppresses only the next: every other
    one is kept, a chain 64 long inside every tile)."""
    if kind == "all":
        return torch.ones(r, k, k, dtype=torch.bool)
    s = torch.zeros(r, k, k, dtype=torch.bool)
    if kind == "chain":
        i = torch.arange(k - 1)
        s[:, i, i + 1] = True
    return s


def _kernel_vs_plain(s: torch.Tensor, dev) -> torch.Tensor:
    want = nms.nms_keep_plain(s)
    _build.reset_launches()
    got = nms.nms_keep(s.to(dev))
    torch.cuda.synchronize()
    assert _build.launches()["nms_keep"] == 1
    assert got.dtype == torch.bool and torch.equal(got.cpu(), want)
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["all", "none", "chain"])
@pytest.mark.parametrize("k", [1, 63, 64, 65, 127, 2048, 3000])
def test_kernel_tiles_equal_plain(cuda, k, kind):
    keep = _kernel_vs_plain(_patterned(2, k, kind), cuda)
    if kind == "chain":
        assert torch.equal(keep[0], torch.arange(k) % 2 == 0)


@pytest.mark.cuda
def test_kernel_past_65535_rows(cuda):
    """More rows than sweep blocks: a block sweeps several rows."""
    _kernel_vs_plain(_t(_suppress(70000, 5, 0.5, 3)), cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [3000, 1100])
@pytest.mark.parametrize("k", [65, 300, 2048])
def test_kernel_in_column_chunks(cuda, k, budget, monkeypatch):
    """A sweep block given 3,000 shared bytes stages two words of a tile a
    time (its removed words, up to 256 bytes, in shared memory); given
    1,100, one word, and at k = 2,048 the removed words live in the
    scratch (256 bytes and a word column do not fit)."""
    monkeypatch.setattr(nms, "_NMS_SMEM_BUDGET", budget)
    _kernel_vs_plain(_t(_suppress(3, k, 0.02, k + budget)), cuda)
    _kernel_vs_plain(_patterned(2, k, "chain"), cuda)
