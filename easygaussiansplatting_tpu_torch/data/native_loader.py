"""ctypes bindings for the native COLMAP parser and the PNG unfilter.

Port of easygaussiansplatting_tpu/data/native_loader.py over the same C++
source, ``native/colmap_reader.cc`` at the repository root, compiled from
where it lies together with the port's ``native/png_unfilter.cc`` into one
library of the port's own, ``build/native/libegs_native_torch.so``. The
host compiler builds it (``g++ -O3 -fPIC -shared -std=c++17``, the flags of
``native/Makefile``) at first use, into a temporary name per process that
``os.replace`` then moves over the library, so processes that build at once
never see a half-written file; ``make`` is never run, and nothing is
written into ``native/``. A library older than either source is rebuilt,
never loaded.

The readers accelerate data/colmap.py's: ``available()`` gates their use,
and the dataset layer falls back to the pure-Python readers with a warning
that shows why the build failed. The PNG decoder (data/image_io.py) has no
such fallback: :func:`library` raises when the library cannot be built.
"""

import ctypes
import functools
import os
import shutil
import subprocess
import warnings
from pathlib import Path

import numpy as np

from easygaussiansplatting_tpu_torch.data.colmap import CAMERA_MODELS, ColmapCamera, ColmapImage

ROOT = Path(__file__).resolve().parents[2]
SOURCES = (ROOT / "native" / "colmap_reader.cc",
           Path(__file__).resolve().parents[1] / "native" / "png_unfilter.cc")
BUILD_DIR = ROOT / "build" / "native"
LIB_NAME = "libegs_native_torch.so"
FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]

_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
# C entry point -> (argument types, return type)
SIGNATURES = {
    "egs_read_points3d": ([ctypes.c_char_p, _PP, _PP, _PP], ctypes.c_int64),
    "egs_read_images": ([ctypes.c_char_p, _PP, _PP, _PP, _PP, _PP,
                         ctypes.POINTER(ctypes.c_int64)], ctypes.c_int64),
    "egs_read_cameras": ([ctypes.c_char_p] + [_PP] * 6, ctypes.c_int64),
    "egs_free": ([_P], None),
    "egs_png_unfilter": ([_P, _P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32],
                         ctypes.c_int64),
}


class NativeBuildError(RuntimeError):
    pass


def fresh(lib, sources=SOURCES):
    """A library older than any of its sources must not shadow code edits."""
    return lib.is_file() and all(
        not s.is_file() or lib.stat().st_mtime >= s.stat().st_mtime for s in sources)


def build(force=False):
    """Compile SOURCES into BUILD_DIR/LIB_NAME unless a fresh one is there.
    Returns the library's path; raises NativeBuildError naming what is
    missing or what the compiler said."""
    lib = BUILD_DIR / LIB_NAME
    if not force and fresh(lib):
        return lib
    missing = [str(s) for s in SOURCES if not s.is_file()]
    if missing:
        raise NativeBuildError(f"native sources not found: {', '.join(missing)}")
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise NativeBuildError("no host C++ compiler: g++ is not on PATH and CXX is not set")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [cxx, *FLAGS, "-o", str(tmp), *(str(s) for s in SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"$ {' '.join(cmd)}\n{res.stderr.strip()}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees old or new, whole
    return lib


@functools.lru_cache(maxsize=None)
def library():
    """The loaded library (built first if needed), every entry point typed."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def available():
    """True when the library builds and loads; otherwise warns with the
    reason (the readers then fall back to data/colmap.py's) and returns
    False."""
    try:
        library()
    except (NativeBuildError, OSError) as e:
        warnings.warn(f"native colmap reader unavailable, using the pure-Python parser: {e}")
        return False
    return True


def _take(ptr, ctype, count, lib):
    """Copy `count` elements from a C buffer into numpy and free it."""
    arr = np.ctypeslib.as_array(
        ctypes.cast(ptr, ctypes.POINTER(ctype)), shape=(count,)
    ).copy()
    lib.egs_free(ptr)
    return arr


def read_points3d_binary(path):
    lib = library()
    xyz_p, rgb_p, err_p = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_void_p()
    n = lib.egs_read_points3d(
        str(path).encode(), ctypes.byref(xyz_p), ctypes.byref(rgb_p), ctypes.byref(err_p)
    )
    if n < 0:
        raise IOError(f"native parse failed: {path}")
    xyz = _take(xyz_p, ctypes.c_double, n * 3, lib).reshape(-1, 3)
    rgb = _take(rgb_p, ctypes.c_uint8, n * 3, lib).reshape(-1, 3)
    err = _take(err_p, ctypes.c_double, n, lib)
    return xyz, rgb, err


def read_images_binary(path):
    lib = library()
    ids_p, cams_p, q_p, t_p, names_p = (ctypes.c_void_p() for _ in range(5))
    names_len = ctypes.c_int64()
    n = lib.egs_read_images(
        str(path).encode(), ctypes.byref(ids_p), ctypes.byref(cams_p),
        ctypes.byref(q_p), ctypes.byref(t_p), ctypes.byref(names_p),
        ctypes.byref(names_len),
    )
    if n < 0:
        raise IOError(f"native parse failed: {path}")
    ids = _take(ids_p, ctypes.c_int32, n, lib)
    cams = _take(cams_p, ctypes.c_int32, n, lib)
    qvecs = _take(q_p, ctypes.c_double, n * 4, lib).reshape(-1, 4)
    tvecs = _take(t_p, ctypes.c_double, n * 3, lib).reshape(-1, 3)
    blob = _take(names_p, ctypes.c_uint8, names_len.value, lib).tobytes()
    names = blob.split(b"\x00")[:n]
    return {
        int(ids[i]): ColmapImage(
            int(ids[i]), qvecs[i], tvecs[i], int(cams[i]), names[i].decode("utf-8")
        )
        for i in range(n)
    }


def read_cameras_binary(path):
    lib = library()
    ids_p, models_p, w_p, h_p, par_p, cnt_p = (ctypes.c_void_p() for _ in range(6))
    n = lib.egs_read_cameras(
        str(path).encode(), ctypes.byref(ids_p), ctypes.byref(models_p),
        ctypes.byref(w_p), ctypes.byref(h_p), ctypes.byref(par_p), ctypes.byref(cnt_p),
    )
    if n < 0:
        raise IOError(f"native parse failed: {path}")
    ids = _take(ids_p, ctypes.c_int32, n, lib)
    models = _take(models_p, ctypes.c_int32, n, lib)
    widths = _take(w_p, ctypes.c_int64, n, lib)
    heights = _take(h_p, ctypes.c_int64, n, lib)
    params = _take(par_p, ctypes.c_double, n * 12, lib).reshape(-1, 12)
    counts = _take(cnt_p, ctypes.c_int32, n, lib)
    return {
        int(ids[i]): ColmapCamera(
            int(ids[i]), CAMERA_MODELS[int(models[i])][0],
            int(widths[i]), int(heights[i]), params[i, : counts[i]].copy(),
        )
        for i in range(n)
    }
