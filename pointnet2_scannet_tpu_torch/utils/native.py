"""ctypes binding to the native host ops (cpp/hostops.cpp) used by serving.

Only the two host ops of the serving path: whole-scene column membership
(tile_columns) and exact coordinate dedup (coord_first_occurrence). The
library is built with `make -C cpp` the first time it is needed; each entry
point has a numpy fallback with the same results, taken when the library
cannot be built or loaded. These run on the host and are not device kernels.
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
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.tile_columns.restype = i64
        lib.tile_columns.argtypes = [
            f32p, i64, f32p, ctypes.c_float, ctypes.c_double,
            ctypes.c_double, i64, i64, i64p, i64p,
        ]
        lib.coord_first_occurrence.restype = i64
        lib.coord_first_occurrence.argtypes = [f32p, i64, i64p]
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
