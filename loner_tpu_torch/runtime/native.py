"""ctypes bindings for the host point-cloud front end
(``loner_tpu_torch/csrc/pointcloud.cpp``), each with its numpy path.

The port of ``loner_tpu/runtime/native.py``: cloud extraction for ICP,
voxel downsampling, the box and range filters and the sky-segmentation
occupancy image. The library is built with ``g++`` at first use into
``build/loner_tpu_torch_native/<hash>/`` beside the package, keyed by a hash
of the source and the flags (no ``-march=native``: the directory is not
keyed by host), with the compiler's output in ``build.log`` there. Where it
cannot be built (no compiler) every function takes its numpy path, the JAX
module's contract for such machines; :func:`has_native` says which path
runs. The ``*_np`` functions are the numpy paths, and each computes the same
numbers as its library function: float32 where the C++ computes in float,
float64 where it computes in double, the same rounding of the stride and
the same voxel order.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "pointcloud.cpp"
BUILD_ROOT = _PKG.parent / "build" / "loner_tpu_torch_native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-ffp-contract=off", "-Wall")
_LIB_NAME = "libloner_native.so"

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
build_log = ""  # g++'s output of the last build, or why there was none


def _lib_dir() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_native() -> Path:
    """Build the library (if it is not built yet); its path. Raises where
    there is no ``g++`` or the build fails."""
    global build_log
    out_dir = _lib_dir()
    if (out_dir / _LIB_NAME).exists():
        build_log = (out_dir / "build.log").read_text() if (out_dir / "build.log").exists() else ""
        return out_dir / _LIB_NAME
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native point-cloud library cannot be built here")
    out_dir.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=out_dir.parent))
    try:
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp / _LIB_NAME), str(SOURCE)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        build_log = " ".join(cmd) + "\n" + proc.stdout
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{proc.stdout}")
        (tmp / "build.log").write_text(build_log)
        try:
            os.replace(tmp, out_dir)  # atomic: a concurrent build may have won
        except OSError:
            if not (out_dir / _LIB_NAME).exists():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out_dir / _LIB_NAME


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED, build_log
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    try:
        lib = ctypes.CDLL(str(build_native()))
    except (RuntimeError, OSError) as e:
        build_log += f"\nnot built or not loaded: {e}"
        return None
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i64, f32, i32 = ctypes.c_int64, ctypes.c_float, ctypes.c_int32
    lib.extract_cloud.argtypes = [f32p, f32p, u8p, i64, f32, i64, f32p, u8p]
    lib.extract_cloud.restype = None
    lib.voxel_downsample.argtypes = [f32p, i64, f32, f32p, i64]
    lib.voxel_downsample.restype = i64
    lib.box_filter.argtypes = [f32p, u8p, i64, f32, f32, f32, f32, f32, f32]
    lib.box_filter.restype = None
    lib.range_filter.argtypes = [f32p, u8p, i64, f32, f32]
    lib.range_filter.restype = None
    lib.spherical_occupancy.argtypes = [f32p, u8p, i64, i32, i32, f32, f32, u8p]
    lib.spherical_occupancy.restype = None
    _LIB = lib
    return lib


def has_native() -> bool:
    """True when the library is built and loaded (the functions run it),
    False when they take their numpy paths."""
    return _lib() is not None


# ---------------------------------------------------------------------------
# extract_cloud
# ---------------------------------------------------------------------------


def extract_cloud(points: np.ndarray, timestamps: np.ndarray, valid: np.ndarray, keep_fraction: float,
                  n_out: int) -> Tuple[np.ndarray, np.ndarray]:
    """The valid points of the first ``keep_fraction`` of the sweep's time
    span, uniform-stride downsampled to exactly ``n_out`` points (zeros and
    an invalid mask pad the tail): ((n_out, 3) f32, (n_out,) bool)."""
    lib = _lib()
    if lib is None:
        return extract_cloud_np(points, timestamps, valid, keep_fraction, n_out)
    points = np.ascontiguousarray(points, np.float32)
    out_p = np.empty((n_out, 3), np.float32)
    out_v = np.empty((n_out,), np.uint8)
    lib.extract_cloud(points, np.ascontiguousarray(timestamps, np.float32), np.ascontiguousarray(valid, np.uint8),
                      len(points), keep_fraction, n_out, out_p, out_v)
    return out_p, out_v.astype(bool)


def extract_cloud_np(points, timestamps, valid, keep_fraction: float, n_out: int):
    points = np.ascontiguousarray(points, np.float32)
    ts = np.ascontiguousarray(timestamps, np.float32)
    vb = np.asarray(valid).astype(bool)
    if vb.any():
        tmin, tmax = ts[vb].min(), ts[vb].max()
        tcut = tmin + np.float32(keep_fraction) * (tmax - tmin)  # float32 scalars, as the C++ floats
        idx = np.flatnonzero(vb & (ts <= tcut))
    else:
        idx = np.zeros(0, np.int64)
    if len(idx) > n_out:
        x = np.arange(n_out, dtype=np.float64) * ((len(idx) - 1) / max(n_out - 1, 1))
        r = np.floor(x)
        r += (x - r) >= 0.5  # llround: halves away from zero
        idx = idx[r.astype(np.int64)]
    out_p = np.zeros((n_out, 3), np.float32)
    out_p[: len(idx)] = points[idx]
    return out_p, np.arange(n_out) < len(idx)


# ---------------------------------------------------------------------------
# voxel_downsample
# ---------------------------------------------------------------------------


def voxel_downsample(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """(M, 3) f32: the mean of the points in each voxel of ``voxel_size``,
    the voxels in ascending (x, y, z) key order."""
    lib = _lib()
    if lib is None:
        return voxel_downsample_np(points, voxel_size)
    points = np.ascontiguousarray(points, np.float32)
    out = np.empty_like(points)
    n = lib.voxel_downsample(points, len(points), voxel_size, out, len(points))
    return out[:n].copy()


def voxel_downsample_np(points, voxel_size: float) -> np.ndarray:
    points = np.ascontiguousarray(points, np.float32)
    inv = 1.0 / float(np.float32(voxel_size))  # the library takes the size as a float
    keys = np.floor(points.astype(np.float64) * inv).astype(np.int64)
    _, inv_idx, counts = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
    sums = np.zeros((counts.shape[0], 3))
    np.add.at(sums, inv_idx.reshape(-1), points)
    return (sums / counts[:, None]).astype(np.float32)


# ---------------------------------------------------------------------------
# box and range filters
# ---------------------------------------------------------------------------


def box_filter(points: np.ndarray, valid: np.ndarray, center, size) -> np.ndarray:
    """The mask with the points inside the axis-aligned box (``size``
    centred at ``center``, sensor frame) made invalid."""
    lib = _lib()
    if lib is None:
        return box_filter_np(points, valid, center, size)
    points = np.ascontiguousarray(points, np.float32)
    v8 = np.array(valid, dtype=np.uint8)
    lib.box_filter(points, v8, len(points), *map(float, center), *map(float, size))
    return v8.astype(bool)


def box_filter_np(points, valid, center, size) -> np.ndarray:
    points = np.ascontiguousarray(points, np.float32)
    half = np.asarray(size, np.float32) * np.float32(0.5)
    inside = np.all(np.abs(points - np.asarray(center, np.float32)[None]) <= half[None], axis=1)
    return np.asarray(valid).astype(bool) & ~inside


def range_filter(distances: np.ndarray, valid: np.ndarray, min_range: float, max_range: float) -> np.ndarray:
    """The mask with the points whose range lies outside [min_range,
    max_range] made invalid."""
    lib = _lib()
    if lib is None:
        return range_filter_np(distances, valid, min_range, max_range)
    distances = np.ascontiguousarray(distances, np.float32)
    v8 = np.array(valid, dtype=np.uint8)
    lib.range_filter(distances, v8, len(distances), min_range, max_range)
    return v8.astype(bool)


def range_filter_np(distances, valid, min_range: float, max_range: float) -> np.ndarray:
    d = np.ascontiguousarray(distances, np.float32)
    out = (d < np.float32(min_range)) | (d > np.float32(max_range))
    return np.asarray(valid).astype(bool) & ~out


# ---------------------------------------------------------------------------
# spherical_occupancy
# ---------------------------------------------------------------------------


def spherical_occupancy(dirs: np.ndarray, valid: np.ndarray, n_az: int, n_el: int, el_lo: float,
                        el_hi: float) -> np.ndarray:
    """(n_el, n_az) bool: the cells of the spherical projection hit by a
    valid direction, row 0 the highest elevation, binned in float64."""
    lib = _lib()
    if lib is None:
        return spherical_occupancy_np(dirs, valid, n_az, n_el, el_lo, el_hi)
    dirs = np.ascontiguousarray(dirs, np.float32)
    out = np.empty((n_el, n_az), np.uint8)
    lib.spherical_occupancy(dirs, np.ascontiguousarray(valid, np.uint8), len(dirs), n_az, n_el, el_lo, el_hi, out)
    return out.astype(bool)


def spherical_occupancy_np(dirs, valid, n_az: int, n_el: int, el_lo: float, el_hi: float) -> np.ndarray:
    d = np.ascontiguousarray(dirs, np.float32)[np.asarray(valid).astype(bool)].astype(np.float64)
    lo, hi = float(np.float32(el_lo)), float(np.float32(el_hi))  # the library takes them as floats
    az = np.arctan2(d[:, 1], d[:, 0])
    el = np.arcsin(np.clip(d[:, 2], -1.0, 1.0))
    inside = (el >= lo) & (el <= hi)
    col = ((az[inside] + np.pi) / (2.0 * np.pi) * n_az).astype(np.int64) % n_az
    row = np.clip(((hi - el[inside]) / (hi - lo) * n_el).astype(np.int64), 0, n_el - 1)
    img = np.zeros((n_el, n_az), bool)
    img[row, col] = True
    return img
