"""On-demand g++ build and ctypes loader of the native frame codec.

Counterpart of ``sphfluidsimulation_tpu/native/build.py``, with one
difference: several processes may load the codec at once (test workers,
parallel exports), so the build runs under an exclusive ``fcntl`` lock,
writes a temporary file next to the library and moves it onto the
library's path with ``os.replace``. No process ever opens a half-written
library, and one that finds the library built while it waited for the lock
does not build it again. The library lands beside the source
(``_framecodec.so``, which ``.gitignore`` covers).
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "framecodec.cpp")
_SO = os.path.join(_DIR, "_framecodec.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _fresh(so_path: str) -> bool:
    return (os.path.exists(so_path)
            and os.path.getmtime(so_path) >= os.path.getmtime(_SRC))


def _build(so_path: str) -> bool:
    """Compile the codec to ``so_path``: into a temporary name in the same
    directory, then ``os.replace`` onto the path (atomic on one file
    system)."""
    tmp = f"{so_path}.{os.getpid()}.tmp.so"
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             _SRC, "-o", tmp],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, so_path)
        return True
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def _declare(lib: ctypes.CDLL) -> None:
    lib.splat_points.restype = ctypes.c_int64
    lib.splat_points.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64, ctypes.c_int64]
    lib.splat_points_alpha.restype = ctypes.c_int64
    lib.splat_points_alpha.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64]
    lib.write_ply_binary.restype = ctypes.c_int32
    lib.write_ply_binary.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]


def open_framecodec(so_path: str = _SO) -> ctypes.CDLL | None:
    """Build the codec at ``so_path`` if it is missing or older than its
    source (under the lock), and open it; None when g++ or the library is
    unavailable."""
    try:
        with open(so_path + ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not _fresh(so_path) and not _build(so_path):
                return None
        lib = ctypes.CDLL(so_path)
    except OSError:
        return None
    _declare(lib)
    return lib


def load_framecodec():
    """ctypes handle to the codec beside the source, or None (callers fall
    back to numpy); opened once a process."""
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            _lib = open_framecodec()
        return _lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def splat_points_native(xy: np.ndarray, z: np.ndarray, r_px: np.ndarray,
                        rgb: np.ndarray, img: np.ndarray) -> int | None:
    """Rasterize into ``img`` (u8[H, W, 3], modified in place); None when
    the native library is unavailable."""
    lib = load_framecodec()
    if lib is None:
        return None
    xy = np.ascontiguousarray(xy, np.float32)
    z = np.ascontiguousarray(z, np.float32)
    r_px = np.ascontiguousarray(r_px, np.float32)
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if not (img.flags["C_CONTIGUOUS"] and img.dtype == np.uint8):
        raise ValueError("img must be a C-contiguous uint8 [H, W, 3] array")
    h, w, _ = img.shape
    return int(lib.splat_points(_fptr(xy), _fptr(z), _fptr(r_px),
                                _u8ptr(rgb), len(z), _u8ptr(img), w, h))


def splat_points_alpha_native(xy: np.ndarray, z: np.ndarray,
                              r_px: np.ndarray, rgb: np.ndarray,
                              alpha: np.ndarray,
                              img: np.ndarray) -> int | None:
    """Translucent rasterization (SrcAlpha src-over, exact painter order)
    into ``img``; None when the native library is unavailable."""
    lib = load_framecodec()
    if lib is None:
        return None
    xy = np.ascontiguousarray(xy, np.float32)
    z = np.ascontiguousarray(z, np.float32)
    r_px = np.ascontiguousarray(r_px, np.float32)
    rgb = np.ascontiguousarray(rgb, np.uint8)
    alpha = np.ascontiguousarray(alpha, np.float32)
    if not (img.flags["C_CONTIGUOUS"] and img.dtype == np.uint8):
        raise ValueError("img must be a C-contiguous uint8 [H, W, 3] array")
    h, w, _ = img.shape
    return int(lib.splat_points_alpha(
        _fptr(xy), _fptr(z), _fptr(r_px), _u8ptr(rgb), _fptr(alpha),
        len(z), _u8ptr(img), w, h))


def write_ply_native(path: str, pos: np.ndarray,
                     rgb: np.ndarray | None) -> bool:
    """Binary little-endian PLY of the points (and colours); False when
    the native library is unavailable or the write fails."""
    lib = load_framecodec()
    if lib is None:
        return False
    pos = np.ascontiguousarray(pos, np.float32)
    if rgb is None:
        rc = lib.write_ply_binary(path.encode(), _fptr(pos), None, len(pos))
    else:
        rgb = np.ascontiguousarray(rgb, np.uint8)
        rc = lib.write_ply_binary(path.encode(), _fptr(pos), _u8ptr(rgb),
                                  len(pos))
    return rc == 0
