"""ctypes bindings for the port's C++ host runtime (csrc/host_ops.cpp).

Counterpart of `mrcnn3d/native/__init__.py`.  The library is built with
g++ at first use into `mrcnn3d_torch/_build/libhost_ops-<hash>.so`, the
hash covering the source, the flags and the host's CPU flags (the flags
of `native/Makefile`; `-march=native` decides the multiply-add
contraction, so a library built for another CPU could round otherwise).
Unlike the JAX package's binding, a failed build or load raises: there
is no numpy fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "host_ops.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-pthread",
             "-shared")


def _cpu_flags() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return platform.processor().encode() or platform.machine().encode()


def library_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode() + _cpu_flags()
    ).hexdigest()
    return BUILD_DIR / f"libhost_ops-{digest[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built; returns its path.
    Raises RuntimeError when g++ fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(
            ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True,
        )
    except OSError as e:
        raise RuntimeError(f"cannot run g++ to build {SOURCE}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"g++ failed for {SOURCE} (rc {proc.returncode}):\n"
            f"{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def get_lib() -> ctypes.CDLL:
    """The host library, built first if needed.  Raises when it cannot
    be built or loaded."""
    path = build()
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"cannot load {path}: {e}") from e
    i64 = ctypes.c_int64
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.crop_normalize_volume.argtypes = [
        f32p, i64, i64, i64, i64, i64, i64, i64, i64, i64, f32p, f32p, f32p
    ]
    lib.crop_normalize_volume.restype = None
    lib.resize_trilinear.argtypes = [
        f32p, i64, i64, i64, i64, i64, i64, i64, f32p
    ]
    lib.resize_trilinear.restype = None
    lib.nms3d_overlap.argtypes = [f32p, i64, ctypes.c_float, i64p]
    lib.nms3d_overlap.restype = i64
    lib.voxel_iou.argtypes = [u8p, u8p, i64]
    lib.voxel_iou.restype = ctypes.c_double
    return lib


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def crop_normalize_volume(vol_hwd, y0, x0, z0, ch, cw, cd, mean, std):
    """(H, W, D) float32 -> cropped normalised (cd, ch, cw, 3) float32."""
    vol = np.ascontiguousarray(vol_hwd, np.float32)
    mean = np.ascontiguousarray(mean, np.float32).reshape(-1)
    std = np.ascontiguousarray(std, np.float32).reshape(-1)
    if vol.ndim != 3 or mean.size != 3 or std.size != 3:
        raise ValueError("expected an (H, W, D) volume and 3 means / stds")
    h, w, d = vol.shape
    if not (0 <= y0 and y0 + ch <= h and 0 <= x0 and x0 + cw <= w
            and 0 <= z0 and z0 + cd <= d and min(ch, cw, cd) >= 0):
        raise ValueError(
            f"crop {(y0, x0, z0, ch, cw, cd)} outside {vol.shape}")
    out = np.empty((cd, ch, cw, 3), np.float32)
    get_lib().crop_normalize_volume(
        _f32p(vol), h, w, d, y0, x0, z0, ch, cw, cd,
        _f32p(mean), _f32p(std), _f32p(out),
    )
    return out


def resize_trilinear(vol_dhwc, od, oh, ow):
    """Channel-last trilinear resize (skimage grid-center convention)."""
    vol = np.ascontiguousarray(vol_dhwc, np.float32)
    if vol.ndim != 4 or min(vol.shape) < 1 or min(od, oh, ow) < 1:
        raise ValueError(f"cannot resize {vol.shape} to {(od, oh, ow)}")
    d, h, w, c = vol.shape
    out = np.empty((od, oh, ow, c), np.float32)
    get_lib().resize_trilinear(_f32p(vol), d, h, w, c, od, oh, ow,
                               _f32p(out))
    return out


def nms3d_overlap(dets, thr):
    """Asymmetric-overlap greedy NMS; returns kept indices (score desc)."""
    dets = np.ascontiguousarray(dets, np.float32)
    if len(dets) == 0:
        return []
    if dets.ndim != 2 or dets.shape[1] != 7:
        raise ValueError(f"expected (n, 7) dets, got {dets.shape}")
    keep = np.empty(len(dets), np.int64)
    n = get_lib().nms3d_overlap(
        _f32p(dets), len(dets), ctypes.c_float(thr),
        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return keep[:n].tolist()


def voxel_iou(a, b):
    """Voxel IoU of two binary volumes of one size."""
    a = np.ascontiguousarray(a, np.uint8)
    b = np.ascontiguousarray(b, np.uint8)
    if a.size != b.size:
        raise ValueError(f"volumes of {a.size} and {b.size} voxels")
    return float(get_lib().voxel_iou(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        a.size,
    ))
