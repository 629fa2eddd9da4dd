"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source compiles with its own ``nvcc`` process, all started
together, into an object under ``build/kernels/`` at the repository root;
the objects link into one shared library with a plain C interface, loaded
with ``ctypes`` (no PyTorch headers, so a build takes seconds, not minutes).
The library is rebuilt when any source under ``csrc/`` is newer than it.

Each C entry point takes device pointers and the CUDA stream as ``void*``,
launches on that stream without synchronising or allocating, and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an error.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine without ``nvcc``.
"""

import ctypes
import functools
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "libegs_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMMON_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# Per-source extra flags. The preprocess chain ends in ceil() on the 3-sigma
# extents, and K12's row extent in floor() on the ellipse's x-range, where
# one ulp of drift can change a tile list: keep nvcc from contracting their
# multiply-adds, so they round where the plain PyTorch chain (one kernel per
# operation) rounds.
EXTRA_FLAGS = {"preprocess.cu": ["-fmad=false"], "binning.cu": ["-fmad=false"]}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_PL = ctypes.POINTER(ctypes.c_longlong)

# C entry point -> argument types (every entry returns cudaError_t as int)
SIGNATURES = {
    "egs_preprocess_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    "egs_preprocess_bwd": [_P] * 13 + [_I, _I, _P],
    # K1's and K2's registers, shared bytes, local (spill) bytes, resident
    # blocks an SM and threads a block for a basis count, to five ints
    "egs_preprocess_fwd_info": [_I, _P],
    "egs_preprocess_bwd_info": [_I, _P],
    # K3 and K6 take uninitialised scratch with its length in int32 words
    "egs_multi_cumsum_i32": [_P, _P, _P, _L, _I, _L, _P],
    "egs_multi_cumsum_f32": [_P, _P, _P, _L, _I, _L, _P],
    "egs_segmented_cumsum_f32": [_P, _P, _P, _P, _L, _I, _L, _P],
    # their plans: tile, launches, memsets and scratch words, to four int64s
    "egs_multi_cumsum_plan": [_L, _I, _PL, _PL, _PL, _PL],
    "egs_segmented_cumsum_plan": [_L, _I, _PL, _PL, _PL, _PL],
    # K4 takes its plan's chunk length and grid, and its state (zeroed by
    # the entry; null for a CTA a tile with nothing counted) and slots
    "egs_rasterize_fwd": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _L, _P,
                          _P],
    # its plan: grid, state words and slot floats, to three int64s
    "egs_rasterize_fwd_plan": [_I, _I, _I, _PL],
    "egs_rasterize_bwd": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _I, _P],
    # K4's (0: a CTA a tile; 2: chunks) or K5's (1) registers and resident
    # blocks an SM, to two ints
    "egs_rasterize_info": [_I, _P],
    # the payload columns go in as two host arrays of device pointers
    # and one uninitialised scratch buffer with its length in int32 words
    "egs_sort": [_P, _P, _I, _P, _P, _I, _P, _P, _P, _L, _L, _L, _P],
    "egs_counting_sort": [_P, _P, _P, _P, _I, _P, _L, _L, _I, _P],
    # their plans: launches and scratch words of a call, written to two int64s
    "egs_sort_plan": [_L, _L, _I, _PL, _PL],
    "egs_counting_sort_plan": [_L, _I, _PL, _PL],
    # the K9 and K10 probes (probes/)
    "egs_stream_chunks": [_P, _L, _I, _P, _I, _P],
    "egs_tile_sums": [_P, _L, _P, _I, _I, _P, _P, _P, _I, _P],
    "egs_stream_sums": [_P, _L, _P, _P, _I, _P, _P],
    # the probes' kernels as compiled (K9b for 0, K9v for 1; K10): registers,
    # shared bytes, local (spill) bytes, resident blocks an SM, threads a
    # block and their layout, to six or seven ints
    "egs_tile_sums_info": [_I, _P],
    "egs_stream_sums_info": [_P],
    # K11, the JPEG encoder: (a) blocks, (b) lengths, (c) pack, (d) stuff
    "egs_jpeg_blocks": [_P, _I, _I, _P, _P, _P],
    "egs_jpeg_lengths": [_P, _L, _P, _P, _P],
    "egs_jpeg_pack": [_P, _L, _P, _P, _P, _L, _P, _P],
    "egs_jpeg_stuff": [_P, _P, _L, _P, _L, _P, _P, _P],
    # its plan for a frame size, to seven int64s; a kernel's registers,
    # shared bytes, local (spill) bytes, resident blocks an SM and threads,
    # to five ints
    "egs_jpeg_plan": [_I, _I, _PL],
    "egs_jpeg_info": [_I, _P],
    # K12, binning: (0) prep, (1) count, (3)+(4) emit and tile counts, (6)
    # place (the depth sort and K3 run between them from the wrapper; the
    # last two take the plan's chunk, chunks, band and bands); its plan, to
    # seven int64s
    "egs_bin_prep": [_P, _L, _P, _L, _P, _L, _P, _P, _L, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "egs_bin_count": [_P, _P, _P, _P, _L, _P, _L, _P, _I, _P, _P],
    "egs_bin_emit": [_P, _P, _P, _L, _P, _L, _P, _I, _I, _I, _P, _P, _I, _L, _P, _P, _P, _P,
                     _P, _I, _I, _I, _I, _P],
    "egs_bin_place": [_P, _P, _P, _P, _P, _I, _L, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "egs_bin_plan": [_I, _L, _PL],
}


class KernelBuildError(RuntimeError):
    pass


def nvcc_path():
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH); the CUDA kernels build only where the CUDA toolkit is installed"
        )
    return found


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _stale(lib):
    if not lib.exists():
        return True
    built = lib.stat().st_mtime
    return any(p.stat().st_mtime > built for p in CSRC.iterdir())


def needs_build():
    """True when the library is missing or older than a source: a process
    that must only load what another one built checks this first."""
    return _stale(BUILD_DIR / LIB_NAME)


def build(force=False):
    """Compile csrc/*.cu into BUILD_DIR/LIB_NAME when stale. Returns
    (library path, seconds spent building, compiler log text)."""
    lib = BUILD_DIR / LIB_NAME
    if not force and not needs_build():
        return lib, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = []
    for src in _sources():
        # per-process object names: processes that start cold together (test
        # workers) must not overwrite each other's objects before the link
        obj = BUILD_DIR / f"{src.stem}.{os.getpid()}.o"
        cmd = [nvcc, *ARCH, *COMMON_FLAGS, *EXTRA_FLAGS.get(src.name, []),
               "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        procs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log = []
    failed = []
    for cmd, _, proc in procs:
        out, err = proc.communicate()
        log.append(f"$ {' '.join(cmd)}\n{out}{err}")
        if proc.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{err}")
    if failed:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(failed))
    tmp = BUILD_DIR / (LIB_NAME + f".{os.getpid()}.tmp")
    cmd = [nvcc, *ARCH, "-shared", *(str(o) for _, o, _ in procs), "-o", str(tmp)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    log.append(f"$ {' '.join(cmd)}\n{res.stdout}{res.stderr}")
    for _, obj, _ in procs:
        obj.unlink()
    if res.returncode != 0:
        raise KernelBuildError(f"nvcc link failed:\n$ {' '.join(cmd)}\n{res.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees old or new, whole
    text = "\n".join(log)
    (BUILD_DIR / "build.log").write_text(text)
    return lib, time.perf_counter() - t0, text


@functools.lru_cache(maxsize=None)
def library():
    """The loaded kernel library (built first if needed), with argtypes and
    restype declared for every entry point."""
    lib_path, _, _ = build()
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(code, name):
    """Raise when a C entry point returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {code}")


def stream_ptr(tensor):
    """The current CUDA stream of ``tensor``'s device, as a pointer value."""
    return torch.cuda.current_stream(tensor.device).cuda_stream
