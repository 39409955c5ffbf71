"""ctypes bridge to the native (C++) host components: the KITTI AP core
(`kitti_eval.cc`) and the voxel budget (`voxelize.cc`).

The port's copy of `ssd3d/native/__init__.py`. The library is built with
`g++` at its first use, never at import, into `build/ssd3d_torch/` at the
repository root (ignored by git), named by a hash of the sources and flags,
so a changed source is rebuilt; the build writes a temporary file and
renames it, so concurrent first uses never load half a library. This is host
code, not a device kernel. The AP core has a pure-numpy twin
(`use_native=False` in `eval.kitti_ap`, also taken where g++ is missing),
and tests cross-check the two; the voxel budget's twin is the numpy branch
of `data.nuscenes.voxel_budget_sample`. `make -C ssd3d_torch/native` runs
the same build by hand.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parents[1] / "build" / "ssd3d_torch"
SOURCES = ("kitti_eval.cc", "voxelize.cc")
# no -march=native: the library may be loaded on another host than the one
# that built it, and no FMA contraction, so its arithmetic is the numpy path's
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-ffp-contract=off", "-shared")

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((_DIR / name).read_bytes())
    return BUILD_DIR / f"libssd3d_torch_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless the one for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("ssd3d_torch.native: g++ was not found on PATH")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), *(str(_DIR / s) for s in SOURCES)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"ssd3d_torch.native: g++ failed:\n{res.stderr}")
    os.replace(tmp, out)
    return out


def load():
    """The loaded library, built at the first call, or None where it cannot
    be built (no g++)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            path = build()
        except (RuntimeError, OSError):
            return None
        lib = ctypes.CDLL(str(path))
        lib.kitti_eval_class.restype = ctypes.c_int
        lib.kitti_eval_class.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_double, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ]
        lib.voxel_budget_flags.restype = ctypes.c_int64
        lib.voxel_budget_flags.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        _lib = lib
        return _lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def kitti_eval_class_native(gt_rows, gt_counts, det_rows, det_counts,
                            cls: int, difficulty: int, metric: int,
                            min_overlap: float, compute_aos: bool):
    """gt_rows: [sum_gt, 15] f32; det_rows: [sum_det, 14] f32 (see
    kitti_eval.cc for layouts). Returns (precision[41], aos[41] or None)."""
    lib = load()
    if lib is None:
        raise RuntimeError("ssd3d_torch.native: the library could not be built")
    gt_rows = np.ascontiguousarray(gt_rows, np.float32)
    det_rows = np.ascontiguousarray(det_rows, np.float32)
    gt_counts = np.ascontiguousarray(gt_counts, np.int32)
    det_counts = np.ascontiguousarray(det_counts, np.int32)
    precision = np.zeros(41, np.float64)
    aos = np.zeros(41, np.float64)
    ret = lib.kitti_eval_class(
        _fptr(gt_rows),
        gt_counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        _fptr(det_rows),
        det_counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(gt_counts), cls, difficulty, metric, min_overlap,
        1 if compute_aos else 0,
        precision.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        aos.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if ret != 0:
        raise RuntimeError(f"kitti_eval_class returned {ret}")
    return precision, (aos if compute_aos else None)


def voxel_budget_flags_native(points: np.ndarray, voxel_size, range_lo,
                              range_hi, max_per_voxel: int) -> np.ndarray:
    lib = load()
    if lib is None:
        raise RuntimeError("ssd3d_torch.native: the library could not be built")
    pts = np.ascontiguousarray(points, np.float32)
    vs = np.ascontiguousarray(voxel_size, dtype=np.float32)
    lo = np.ascontiguousarray(range_lo, dtype=np.float32)
    hi = np.ascontiguousarray(range_hi, dtype=np.float32)
    keep = np.zeros(len(pts), np.uint8)
    kept = lib.voxel_budget_flags(
        _fptr(pts), len(pts), pts.shape[1], _fptr(vs), _fptr(lo), _fptr(hi),
        max_per_voxel, keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if kept < 0:
        raise RuntimeError(f"voxel_budget_flags returned {kept}")
    return keep.astype(bool)
