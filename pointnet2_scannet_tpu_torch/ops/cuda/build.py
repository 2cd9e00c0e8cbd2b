"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source compiles with its own nvcc process, all started together, and
the objects link into one shared library with a plain C interface, loaded
through ctypes: no PyTorch headers are compiled, so a cold build takes
seconds. The library is named after a hash of the sources and
the flags, so a changed source rebuilds and an unchanged one loads the
library already built. Nothing here runs at import time; the first kernel
launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

_PKG = pathlib.Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = (
    "fps.cu", "ball_query.cu", "ball_query_multi.cu", "gather.cu", "three_nn.cu", "scatter_add.cu",
    "gather_smem.cu", "scatter_smem.cu", "fused_gather_mm.cu", "fps_probe.cu",
)
HEADERS = (
    "sqdist.cuh", "smem_limit.cuh", "csr_sort.cuh", "fps_step.cuh", "on_device.cuh", "ball_scan.cuh",
)
# sm_90a: Hopper. -fmad=false: no a*b+c contraction anywhere in these sources,
# so every distance rounds like the plain PyTorch versions (see sqdist.cuh).
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH, "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_vp = ctypes.c_void_p
_i = ctypes.c_int
_SIGNATURES = {
    "p2_fps": [_vp, _i, _i, _i, _i, _i, _i, _i, _i, _vp, _i, _vp],
    "p2_fps_probe": [_i, _vp, _i, _i, _i, _i, _vp, _vp],
    "p2_fps_clusters": [_i, _i, _i, _i, _i, _i, ctypes.POINTER(_i)],
    "p2_ball_query": [_vp, _vp, _i, _i, _i, ctypes.c_float, _i, _i, _i, _i, _i, _vp, _i, _vp],
    "p2_ball_query_multi": [_vp, _vp, _i, _i, _i, ctypes.c_float, _i, ctypes.c_float, _i, _i, _i,
                            _i, _i, _vp, _vp, _i, _vp],
    "p2_gather": [_vp, _vp, _i, _i, _i, _i, _i, _i, _i, _vp, _i, _vp],
    "p2_three_nn": [_vp, _vp, _i, _i, _i, _i, _i, _vp, _vp, _i, _vp],
    "p2_scatter_add": [_vp, _vp, _i, _i, _i, _i, _i, _i, _i, _i, _i, _i, _vp, _i, _vp],
    "p2_scatter_add_sort": [_vp, _vp, _i, _i, _i, _i, _i, _i, _i, _i, _vp, _vp, _i, _vp],
    "p2_gather_smem": [_vp, _vp, _i, _i, _i, _i, _i, _i, _i, _i, _vp, _i, _vp],
    "p2_scatter_smem": [_vp, _vp, _i, _i, _i, _i, _i, _i, _i, _i, _vp, _vp, _i, _vp],
    "p2_scatter_smem_accumulate": [_vp, _vp, _i, _i, _i, _i, _i, _i, _vp, _i, _vp],
    "p2_fused_gather_mm": [_vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _i, _vp, _i, _vp],
}

# batch rows a launch takes: the kernels that run one grid row (or slice) a
# batch row stop at gridDim.y's (and gridDim.z's) limit
MAX_BATCH = 65535

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the last build, if any
build_log: str = ""  # nvcc/ptxas output of the last build (registers, smem)


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None:
        path = pathlib.Path(CUDA_HOME) / "bin" / "nvcc"
        if path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path() -> pathlib.Path:
    return BUILD_DIR / f"libpn2_kernels_{_digest()}.so"


def _build(target: pathlib.Path) -> None:
    global build_seconds, build_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = f"{target.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{stem}.{pathlib.Path(s).stem}.o" for s in SOURCES]
    tmp = BUILD_DIR / f"{stem}.so.tmp"
    t0 = time.perf_counter()
    logs = []
    try:
        procs = [
            subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(SOURCES, objs)
        ]
        codes = []
        for proc in procs:
            out, _ = proc.communicate()
            logs.append(out)
            codes.append(proc.returncode)
        if not any(codes):
            link = subprocess.run(
                [_nvcc(), *ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
                capture_output=True, text=True,
            )
            logs.append(link.stdout + link.stderr)
            codes.append(link.returncode)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    if any(codes):
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({codes}):\n{build_log}")
    os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing


def ensure_built() -> pathlib.Path:
    """The library's path, built first where it is missing (not loaded). A
    data-parallel host runs this on one rank while the others wait
    (parallel/distributed.build_once_per_host), so N ranks start one build."""
    path = library_path()
    if not path.exists():
        _build(path)
    return path


def library() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(ensure_built()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.p2_error_string.argtypes = [ctypes.c_int]
        lib.p2_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, kernel: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = library().p2_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {err} ({msg})")


def stream_of(t) -> int:
    """PyTorch's current stream on the tensor's device, as the address that
    ctypes passes for a void* (the raw accessor: a Stream object costs the
    host more than launching a small kernel)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.get_device())


_sm_counts: dict[int, int] = {}


def sm_count(t) -> int:
    """Streaming multiprocessors of the card that holds the tensor."""
    import torch

    index = t.get_device()
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sm_counts[index]


def ptr(t) -> int:
    """The tensor's data address, which ctypes passes for a void*."""
    return t.data_ptr()


def check_batch(b: int, kernel: str) -> None:
    """Raise a ValueError naming the limit where a batch of b rows passes
    MAX_BATCH, before anything is allocated or launched (the C entry points
    refuse it too, as a bare "invalid argument")."""
    if b > MAX_BATCH:
        raise ValueError(f"{kernel} takes a batch of at most {MAX_BATCH} rows, got B = {b}")


def require(t, what: str, dtypes, ndim: int, last: int | None = None) -> None:
    """Raise on a tensor the kernels do not take: not on a CUDA device, of
    another dtype or rank, or not contiguous."""
    if not t.is_cuda:
        raise ValueError(f"{what} must lie on a CUDA device, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what} must be {' or '.join(map(str, dtypes))}, got {t.dtype}")
    if t.dim() != ndim or (last is not None and t.shape[-1] != last):
        raise ValueError(f"{what} has shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
