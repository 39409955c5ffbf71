"""Build and load the port's CUDA kernels.

`ssd3d_torch/csrc/*.cu` are compiled by `nvcc` into one shared library with a
plain C interface and loaded with `ctypes`; one `nvcc` per source runs in
parallel, then one link. The build happens at the first
launch of any kernel, never at import, so every module imports on a machine
without `nvcc` or a GPU. The library lands in `build/ssd3d_torch/` at the
repository root, named by a hash of the sources and flags, so a changed source
is rebuilt and an unchanged one is loaded as is.

Every C entry point returns `cudaGetLastError()` after its launch; `Kernel`
raises if that is not 0, because a refused launch never runs and a later
synchronize does not report it. Each wrapper runs on its input's card
(`on_input_device`): its occupancy queries read that card and its launches
go to that card's current stream, whichever card the process made current.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ssd3d_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""  # nvcc's output (ptxas register / spill report) of the last build


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(home) / "bin" / "nvcc"
        nvcc = str(cand) if cand.exists() else None
    if nvcc is None:
        raise RuntimeError(
            "ssd3d_torch: cannot build the CUDA kernels: nvcc was not found on "
            "PATH or under $CUDA_HOME/bin. CUDA tensors need the kernels; CPU "
            "tensors take the plain PyTorch versions and need no build."
        )
    return nvcc


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libssd3d_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sorted(CSRC.glob("*.cu"))]
    # one nvcc per source, all started together, then one link
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sorted(CSRC.glob("*.cu")), objs)]
    logs = [p.communicate()[0] for p in procs]
    build_log = "".join(logs)
    failed = [p.returncode for p in procs if p.returncode != 0]
    if not failed:
        res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                             capture_output=True, text=True)
        build_log += res.stdout + res.stderr
        failed = [res.returncode] if res.returncode != 0 else []
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"ssd3d_torch: nvcc failed (exit {failed[0]}):\n{build_log}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        return _lib


class Kernel:
    """One C entry point of the library, with its launch count.

    `launches` goes up by one each time the kernel is launched, and nowhere
    else; `chip_smoke.py` reads it to show the main path went through it. A
    kernel with routes (K1, K2, K2m, K3, K7, K10) also counts each launch under the
    route the caller names, in `by_route`."""

    def __init__(self, name: str, symbol: str, argtypes: list):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.by_route: dict[str, int] = {}
        self._fn = None

    def __call__(self, *args, route: str | None = None) -> None:
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = self.argtypes + [ctypes.c_void_p]  # + the stream
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(
                f"ssd3d_torch: kernel {self.name} ({self.symbol}) failed to "
                f"launch: cudaError {err}"
            )
        self.launches += 1
        if route is not None:
            self.by_route[route] = self.by_route.get(route, 0) + 1


def on_input_device(fn):
    """Decorator of a kernel wrapper: runs it with the card of its first
    tensor argument as the current device, so that the route's occupancy
    queries read that card and `Kernel` launches on its current stream (a
    rank on cuda:k that never made k current would otherwise launch on
    card 0's stream). CPU tensors pass through (the wrapper raises)."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        dev = next(a.device for a in args if isinstance(a, torch.Tensor))
        if dev.type != "cuda":
            return fn(*args, **kwargs)
        with torch.cuda.device(dev):
            return fn(*args, **kwargs)
    return run


P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the three D-FPS routes, counted apart in FPS.by_route (the two last ints:
# the route, 0 one block a cloud, 1 a cluster a cloud, 2 a cluster of slices;
# and the slice route's cluster size)
FPS = Kernel("fps", "ssd3d_dfps", [P, P, P, I, I, I, I, I])
# the three F-FPS routes (the two last ints: the route, 0 one block a cloud,
# 1 a cluster of slices in shared memory, 2 streamed; and the cluster route's
# cluster size)
FFPS = Kernel("ffps", "ssd3d_ffps", [P, P, P, I, I, I, I, I, I])
# both ball-query routes (the int after the ring arrays: 1 for the grid, with
# its scratch, cell cap and least cell edge)
BALL_QUERY = Kernel("ball_query", "ssd3d_ball_query",
                    [P, P, P, P, I, I, I, I, P, P, P, P, I, P, P, P, I, ctypes.c_double])
GATHER = Kernel("gather", "ssd3d_gather_rows", [P, P, P, I, I, I, I])
SCATTER_ADD = Kernel("scatter_add", "ssd3d_scatter_add_rows", [P, P, P, P, P, P, I, I, I, I])
# the last int: slices of the knowns
THREE_NN = Kernel("three_nn", "ssd3d_three_nn", [P, P, P, P, I, I, I, I])
# both K7 routes (the last int: 0 FMA, 1 wgmma)
SA_FUSED = Kernel("sa_fused", "ssd3d_sa_fused",
                  [P, P, P, P, P, I, I, I, I, I, P, P, P, I, P, P, P, P, I])
# F-FPS over a given distance matrix, both routes (the five last ints: the
# route, 0 one block a cloud, 1 a cluster a cloud; running minima a thread in
# registers, 0 for the block route's scratch buffer; and the cluster route's
# cluster size, threads a CTA and exchange)
FFPS_DIST = Kernel("ffps_dist", "ssd3d_ffps_dist", [P, P, P, I, I, I, I, I, I, I, I])
# NMS's greedy keep sweep (K8): suppress, scratch, keep, rows, candidates and
# the sweep block's shared-memory budget
NMS_KEEP = Kernel("nms_keep", "ssd3d_nms_keep", [P, P, P, I, I, I])
# the attention-ordered ball query (K9): xyz, new_xyz, feats, new_feats, a_sq,
# b_sq, idx, cnt, the ball list (scratch), b, n, queries, channels, bf16 (0 or
# 1), r2, ns, and the query tile's and the shared-memory tier's largest balls
BALL_QUERY_ATTENTION = Kernel("ball_query_attention", "ssd3d_ball_query_attention",
                              [P, P, P, P, P, P, P, P, P, I, I, I, I, I, ctypes.c_float, I, I,
                               I])
# the eval-mode PointConv epilogue (K10), both routes: y, bias, inv, shift,
# has (or null), out, rows, ns (0 for the rows route), c, y in bf16, out in
# bf16 (0 or 1 each), the card's SM count
CONV_EPILOGUE = Kernel("conv_epilogue", "ssd3d_conv_epilogue", [P, P, P, P, P, P, L, I, I, I, I, I])
KERNELS = (FPS, FFPS, BALL_QUERY, GATHER, SCATTER_ADD, THREE_NN, SA_FUSED, FFPS_DIST, NMS_KEEP,
           BALL_QUERY_ATTENTION, CONV_EPILOGUE)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
        k.by_route = {}


def launches() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


def route_launches() -> dict[str, dict[str, int]]:
    """Launches by route of the kernels that have routes (K1, K2, K3, K7, K2m, K10)."""
    return {k.name: dict(k.by_route)
            for k in (FPS, FFPS, BALL_QUERY, SA_FUSED, FFPS_DIST, CONV_EPILOGUE)}


_sm_counts: dict[int, int] = {}


def sm_count() -> int:
    """The current card's streaming multiprocessors (cached by card)."""
    dev = torch.cuda.current_device()
    if dev not in _sm_counts:
        _sm_counts[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _sm_counts[dev]


def dfps_cluster_size(b: int, n: int) -> int:
    """The cluster size K1's cluster route takes for b clouds of n points on
    the current card (an occupancy query; nothing is launched)."""
    size = library().ssd3d_dfps_cluster_size(b, n)
    if size <= 0:
        raise RuntimeError(f"ssd3d_torch: cluster occupancy query failed: cudaError {-size}")
    return size


_dfps_slice_clusters: dict[tuple[int, int, int], int] = {}


def dfps_slice_clusters(n: int, size: int) -> int:
    """How many of K1's slice-route clusters of `size` CTAs for clouds of n
    points are resident at once on the current card (an occupancy query,
    cached by card; nothing is launched)."""
    key = (torch.cuda.current_device(), n, size)
    if key not in _dfps_slice_clusters:
        active = library().ssd3d_dfps_slice_clusters(n, size)
        if active < 0:
            raise RuntimeError(f"ssd3d_torch: D-FPS occupancy query failed: cudaError {-active}")
        _dfps_slice_clusters[key] = active
    return _dfps_slice_clusters[key]


_ffps_clusters: dict[tuple[int, int, int, int], int] = {}


def ffps_max_clusters(n: int, c: int, size: int) -> int:
    """How many of K2's clusters of `size` CTAs for an n x c cloud are
    resident at once on the current card (an occupancy query, cached by
    card; nothing is launched)."""
    key = (torch.cuda.current_device(), n, c, size)
    if key not in _ffps_clusters:
        active = library().ssd3d_ffps_max_clusters(n, c, size)
        if active < 0:
            raise RuntimeError(f"ssd3d_torch: F-FPS occupancy query failed: cudaError {-active}")
        _ffps_clusters[key] = active
    return _ffps_clusters[key]


_ffps_dist_clusters: dict[tuple[int, int, int, int], int] = {}


def ffps_dist_max_clusters(size: int, threads: int, ppt: int) -> int:
    """How many of K2m's cluster-route clusters of `size` CTAs of `threads`
    threads, `ppt` running minima a thread, are resident at once on the
    current card (an occupancy query, cached by card; nothing is launched)."""
    key = (torch.cuda.current_device(), size, threads, ppt)
    if key not in _ffps_dist_clusters:
        active = library().ssd3d_ffps_dist_max_clusters(size, threads, ppt)
        if active < 0:
            raise RuntimeError(f"ssd3d_torch: K2m occupancy query failed: cudaError {-active}")
        _ffps_dist_clusters[key] = active
    return _ffps_dist_clusters[key]


def resolve_device(device: torch.device | str) -> torch.device:
    """An entry point's device. The entry points default to "cuda"; asking
    for the card where there is none raises here, instead of carrying on
    quietly on the CPU or failing later inside `.to()`."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ssd3d_torch: device 'cuda' was asked for (the default of every entry "
            "point) but torch.cuda.is_available() is false. Pass device='cpu' to run "
            "the plain PyTorch versions on the CPU."
        )
    return dev


def require_cuda(op: str, *tensors: torch.Tensor) -> bool:
    """The public ops' device check before their custom op dispatches: True
    for CUDA tensors (the kernel), False for CPU tensors (the plain
    version); anything else, or a mix, raises with the op's name."""
    devs = {t.device.type for t in tensors}
    if devs == {"cuda"}:
        return True
    if devs == {"cpu"}:
        return False
    raise ValueError(f"{op}: tensors must all be on CUDA or all on CPU, got {devs}")
