"""ctypes binding to the native host ops (cpp/hostops.cpp).

The host ops of the serving and chunked-training paths: whole-scene column
membership (tile_columns), exact coordinate dedup (coord_first_occurrence),
the chunk crop-and-validity scan (chunk_scan) and the metrics' voxel
first-occurrence passes (voxelize_unique, dedup_voxelize). The library is built with `make -C cpp` the first time it
is needed; each entry point has a numpy fallback with the same results,
taken when the library cannot be built or loaded (dedup_voxelize returns
None and its caller takes the two-step path). These run on the host and are
not device kernels.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess

import numpy as np

_CPP_DIR = pathlib.Path(__file__).resolve().parents[2] / "cpp"
_LIB_PATH = _CPP_DIR / "libhostops.so"


class _Native:
    """Lazily built and loaded library; `lib` is None when unavailable."""

    def __init__(self):
        self._lib = None
        self._tried = False

    @property
    def lib(self):
        if not self._tried:
            self._tried = True
            self._lib = self._load()
        return self._lib

    @staticmethod
    def _load():
        src = _CPP_DIR / "hostops.cpp"
        stale = _LIB_PATH.exists() and src.exists() and (
            src.stat().st_mtime > _LIB_PATH.stat().st_mtime
        )
        if not _LIB_PATH.exists() or stale:
            try:
                subprocess.run(
                    ["make", "-B", "-C", str(_CPP_DIR)], check=True, capture_output=True
                )
            except (OSError, subprocess.CalledProcessError):
                if not _LIB_PATH.exists():
                    return None  # no toolchain: numpy fallbacks
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
        except OSError:
            return None
        i64 = ctypes.c_int64
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i64pp = ctypes.POINTER(i64)
        signatures = {
            "tile_columns": [
                f32p, i64, f32p, ctypes.c_float, ctypes.c_double,
                ctypes.c_double, i64, i64, i64p, i64p,
            ],
            "coord_first_occurrence": [f32p, i64, i64p],
            "chunk_scan": [f32p, f32p, i64, f32p, f32p, ctypes.c_float, u8p, i64pp, i64pp],
            "voxelize_unique": [f32p, i64, ctypes.c_double, f32p, f64p, i64p, i64p],
            "dedup_voxelize": [f32p, i64, ctypes.c_double, f32p, f64p, i64p, i64p, i64pp],
        }
        try:
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.restype = i64
                fn.argtypes = argtypes
        except AttributeError:  # a library built from an older hostops.cpp
            return None
        return lib


_native = _Native()


def tile_columns(
    xyz: np.ndarray,
    coordmin: np.ndarray,
    zextent: float,
    L: float,
    tol: float,
    nx: int,
    ny: int,
):
    """Whole-scene column membership.

    Returns (counts (nx, ny) int64, members int64): the point indices of every
    column concatenated in (i-major, j-minor) order, ascending within a
    column; points within +-tol of a border appear in several columns.
    """
    lib = _native.lib
    xyz = np.ascontiguousarray(xyz, np.float32)
    coordmin = np.ascontiguousarray(coordmin, np.float32)
    n = len(xyz)
    # the native scan looks one bin either side and holds 4n members, which
    # needs tol < L/2; wider tolerances take the per-column loop below
    if lib is not None and tol * 2.0 < L:
        counts = np.empty(nx * ny, np.int64)
        members = np.empty(max(4 * n, 16), np.int64)
        total = lib.tile_columns(
            xyz, n, coordmin, ctypes.c_float(zextent),
            ctypes.c_double(L), ctypes.c_double(tol), nx, ny, counts, members,
        )
        if total >= 0:
            return counts.reshape(nx, ny), members[:total]
    cmin = coordmin.astype(np.float64)
    counts = np.zeros((nx, ny), np.int64)
    out = []
    for i in range(nx):
        for j in range(ny):
            curmin = cmin + [i * L, j * L, 0.0]
            curmax = cmin + [(i + 1) * L, (j + 1) * L, float(zextent)]
            mask = np.all((xyz >= curmin - tol) & (xyz <= curmax + tol), axis=1)
            idx = np.flatnonzero(mask)
            counts[i, j] = len(idx)
            out.append(idx.astype(np.int64))
    return counts, np.concatenate(out) if out else np.empty(0, np.int64)


def coord_first_occurrence(coords: np.ndarray) -> np.ndarray:
    """Ascending indices of the first occurrence of each unique (x, y, z) row."""
    lib = _native.lib
    coords = np.ascontiguousarray(coords, np.float32)
    n = len(coords)
    if lib is not None:
        out_idx = np.empty(n, np.int64)
        m = lib.coord_first_occurrence(coords, n, out_idx)
        return np.sort(out_idx[:m])
    view = coords.view(np.dtype((np.void, 12))).ravel()
    _, ids = np.unique(view, return_index=True)
    return np.sort(ids)


def chunk_scan(xyz: np.ndarray, labels: np.ndarray, lo: np.ndarray, hi: np.ndarray, margin: float):
    """Fused chunk crop + validity scan: (mask (n,) bool of the points inside
    [lo - margin, hi + margin], count of those with label > 0, occupied
    cells of a 31x31x62 grid over the points within 0.01 of [lo, hi])."""
    lib = _native.lib
    xyz = np.ascontiguousarray(xyz, np.float32)
    labels = np.ascontiguousarray(labels, np.float32)
    lo = np.ascontiguousarray(lo, np.float32)
    hi = np.ascontiguousarray(hi, np.float32)
    n = len(xyz)
    if lib is not None:
        mask = np.empty(n, np.uint8)
        annotated = ctypes.c_int64()
        occupied = ctypes.c_int64()
        lib.chunk_scan(
            xyz, labels, n, lo, hi, ctypes.c_float(margin), mask,
            ctypes.byref(annotated), ctypes.byref(occupied),
        )
        return mask.astype(bool), int(annotated.value), int(occupied.value)
    mask = np.all((xyz >= lo - margin) & (xyz <= hi + margin), axis=1)
    sel = xyz[mask]
    annotated = int(np.sum(labels[mask] > 0))
    tight = np.all((sel >= lo - 0.01) & (sel <= hi + 0.01), axis=1)
    extent = hi - lo
    if (extent <= 0).any() or not tight.any():
        return mask, annotated, 0
    vidx = np.ceil((sel[tight] - lo) / extent * [31.0, 31.0, 62.0])
    vidx = np.unique(vidx[:, 0] * 31.0 * 62.0 + vidx[:, 1] * 62.0 + vidx[:, 2])
    return mask, annotated, len(vidx)


def dedup_voxelize(coords: np.ndarray, res: float, coordmin, nvox):
    """One pass of exact-row coordinate dedup and voxel first occurrence over
    the surviving rows: (keep_idx ascending, vox_idx: each voxel's
    representative row, in first-encounter order), or None without the
    library (or for empty / non-float32 coords)."""
    lib = _native.lib
    n = len(coords)
    if lib is None or n == 0 or coords.dtype != np.float32:
        return None
    coords = np.ascontiguousarray(coords)
    keep_idx = np.empty(n, np.int64)
    vox_idx = np.empty(n, np.int64)
    vox_count = ctypes.c_int64(0)
    m = lib.dedup_voxelize(
        coords, n, float(res), np.ascontiguousarray(coordmin, np.float32),
        np.ascontiguousarray(nvox, np.float64), keep_idx, vox_idx, ctypes.byref(vox_count),
    )
    return keep_idx[:m], vox_idx[: vox_count.value]


def voxelize_unique(coords: np.ndarray, res: float, coordmin, nvox):
    """(sorted unique voxel ids as float64, index of the first point in each)
    for a grid of `res` from coordmin; the native pass reproduces the float32
    numpy formula bit for bit and runs only for float32 coords."""
    lib = _native.lib
    n = len(coords)
    if lib is not None and n > 0 and coords.dtype == np.float32:
        coords = np.ascontiguousarray(coords)
        out_idx = np.empty(n, np.int64)
        out_keys = np.empty(n, np.int64)
        m = lib.voxelize_unique(
            coords, n, float(res), np.ascontiguousarray(coordmin, np.float32),
            np.ascontiguousarray(nvox, np.float64), out_idx, out_keys,
        )
        out_idx, out_keys = out_idx[:m], out_keys[:m]
        order = np.argsort(out_keys, kind="stable")
        return out_keys[order].astype(np.float64), out_idx[order]
    vidx = np.ceil((coords - np.asarray(coordmin, coords.dtype)) / res)
    vidx = vidx[:, 0] + vidx[:, 1] * nvox[0] + vidx[:, 2] * nvox[0] * nvox[1]
    uvidx, vpidx = np.unique(vidx.astype(np.int64), return_index=True)
    return uvidx.astype(np.float64), vpidx
