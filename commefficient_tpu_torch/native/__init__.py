"""The host batch assembly in C++ (``fedloader.cc``), loaded through ctypes.

The port's own copy of ``commefficient_tpu/native``: a round's batch is one
gather of ``W*B`` sample rows by index plus the augment (the CIFAR prep or
ImageNet's random-resized-crop), done as one OpenMP pass over the training
set. ctypes releases the GIL for each call, so under the sampler's
``prefetch`` thread (or the pipelined engine's worker) the assembly runs
beside the round the main thread launches.

The library is compiled at first use with ``g++ -shared -fPIC -fopenmp
-ffp-contract=off`` into ``build/native/libfedloader_<hash>.so`` at the
repository root (``build/`` is in ``.gitignore``), keyed by a hash of the
source and the flags, so a fresh checkout builds it with no step of its own
and an edited source rebuilds. A process builds to a temporary file of its
own and moves it into place with ``os.replace``: several processes (pytest
workers, ranks) may build at once. ``-ffp-contract=off`` and no
``-march=native`` keep the RRC's float32 arithmetic numpy's, so the output
is bit-equal to the numpy path in float32 and uint8.

Every entry point returns None where the library is not available (no
``g++``, or a build that failed: its compiler output is in
``build_error()``), and its callers fall back to numpy. ``available()``
says which path runs. OpenMP's thread count is ``OMP_NUM_THREADS`` when
set, else the host's cores (``omp_threads()``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
import warnings
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "fedloader.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ("-O3", "-fopenmp", "-ffp-contract=off")

_lock = threading.Lock()
_lib = None
_failed: Optional[str] = None  # the failed build's compiler output
build_seconds: Optional[float] = None  # this process's g++ wall time

_F32P = ctypes.POINTER(ctypes.c_float)
_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libfedloader_{h.hexdigest()[:16]}.so"


def _compile() -> Optional[str]:
    """Build the library unless it exists; None on success, else the
    compiler's message."""
    global build_seconds
    out = library_path()
    if out.exists():
        return None
    gxx = shutil.which("g++")
    if gxx is None:
        return "g++ not found on PATH"
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    try:
        res = subprocess.run([gxx, *FLAGS, "-shared", "-fPIC", "-o", str(tmp),
                              str(SOURCE)], capture_output=True, text=True,
                             timeout=300, check=False)
        if res.returncode != 0:
            return f"g++ {' '.join(FLAGS)} ({res.returncode}): {res.stderr}"
        os.replace(tmp, out)
        build_seconds = time.perf_counter() - t0
        return None
    except subprocess.TimeoutExpired:
        return "g++ timed out"
    finally:
        tmp.unlink(missing_ok=True)


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, ptr in (("fedloader_gather_augment", _F32P),
                      ("fedloader_gather_augment_u8", _U8P)):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, _I64P, ctypes.c_int64, _I32P, _I32P,
                       _U8P, _I32P, _I32P, ctypes.c_int, ctypes.c_int, _F32P,
                       ptr]
        fn.restype = None
    for name, ptr in (("fedloader_gather_rrc", _F32P),
                      ("fedloader_gather_rrc_u8", _U8P)):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, _I64P, ctypes.c_int64, _I32P, _I32P,
                       _I32P, _I32P, _U8P, ptr]
        fn.restype = None
    lib.fedloader_gather_rows.argtypes = [
        ctypes.c_char_p, _I64P, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_char_p]
    lib.fedloader_gather_rows.restype = None
    lib.fedloader_omp_threads.argtypes = []
    lib.fedloader_omp_threads.restype = ctypes.c_int
    return lib


def load() -> Optional[ctypes.CDLL]:
    """The bound library, built on the first call; None when it cannot be
    built (a warning gives the compiler's message once)."""
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed is not None:
            return _lib
        err = _compile()
        if err is None:
            try:
                _lib = _bind(library_path())
                return _lib
            except OSError as e:
                err = f"dlopen {library_path()}: {e}"
        _failed = err
        warnings.warn("the native batch assembly could not be built; the "
                      f"sampler assembles batches in numpy:\n{_failed}",
                      RuntimeWarning, stacklevel=2)
        return None


def available() -> bool:
    return load() is not None


def build_error() -> Optional[str]:
    """The compiler's message when the build failed, else None."""
    load()
    return _failed


def omp_threads() -> int:
    """The OpenMP threads a call starts from the calling thread (0 without
    the library)."""
    lib = load()
    return 0 if lib is None else int(lib.fedloader_omp_threads())


def _check_idx(idx: np.ndarray, n_rows: int) -> None:
    """The C loops do no bounds checks: an index outside the data would be
    an out-of-bounds read, so it is refused here."""
    if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= n_rows):
        raise IndexError(
            f"gather index out of range: [{int(idx.min())}, "
            f"{int(idx.max())}] vs {n_rows} data rows")


def _out(out: Optional[np.ndarray], shape, dtype) -> np.ndarray:
    """``out`` checked to be a C-contiguous ``shape``/``dtype`` buffer, or a
    new one."""
    if out is None:
        return np.empty(shape, dtype)
    if (out.shape != tuple(shape) or out.dtype != dtype
            or not out.flags.c_contiguous or not out.flags.writeable):
        raise ValueError(f"out must be a writable C-contiguous {dtype} array "
                         f"of shape {tuple(shape)}, got {out.dtype} "
                         f"{out.shape}")
    return out


def _checked(data: np.ndarray, idx: np.ndarray):
    data = np.ascontiguousarray(data)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    _check_idx(idx, data.shape[0])
    return data, idx


def gather_augment(data: np.ndarray, idx: np.ndarray, plan=None, *,
                   pad: int = 4, cut_half: int = 4,
                   fill: Optional[np.ndarray] = None,
                   out: Optional[np.ndarray] = None) -> Optional[np.ndarray]:
    """``out[i] = augment(data[idx[i]])``: ``data`` ``[N, H, W, C]`` float32
    or uint8, ``plan`` a ``CifarAugment`` plan (None: a plain gather),
    ``fill`` the ``[C]`` cutout fill in the data's scale (None: zeros).
    ``out`` (optional) receives the ``[n, H, W, C]`` result. None when the
    library is not available."""
    lib = load()
    if lib is None or data.ndim != 4:
        return None
    if data.dtype == np.uint8:
        fn, ptr = lib.fedloader_gather_augment_u8, _U8P
    elif data.dtype == np.float32:
        fn, ptr = lib.fedloader_gather_augment, _F32P
    else:
        return None
    data, idx = _checked(data, idx)
    n = int(idx.shape[0])
    _, h, w, c = data.shape
    res = _out(out, (n, h, w, c), data.dtype)
    keep = []  # the plan's arrays outlive the call
    if plan is None:
        args = (_I32P(), _I32P(), _U8P(), _I32P(), _I32P(), 0, 0, _F32P())
    else:
        arrs = [np.ascontiguousarray(a, t) for a, t in (
            (plan.ys, np.int32), (plan.xs, np.int32), (plan.flips, np.uint8),
            (plan.cys, np.int32), (plan.cxs, np.int32))]
        if any(len(a) != n for a in arrs):
            raise ValueError(f"plan arrays must match idx length {n}")
        fill_arr = (np.zeros((c,), np.float32) if fill is None else
                    np.ascontiguousarray(np.broadcast_to(fill, (c,)),
                                         dtype=np.float32))
        keep = arrs + [fill_arr]
        ys, xs, fl, cys, cxs = arrs
        args = (ys.ctypes.data_as(_I32P), xs.ctypes.data_as(_I32P),
                fl.ctypes.data_as(_U8P), cys.ctypes.data_as(_I32P),
                cxs.ctypes.data_as(_I32P), pad, cut_half,
                fill_arr.ctypes.data_as(_F32P))
    fn(data.ctypes.data_as(ptr), data.shape[0], h, w, c,
       idx.ctypes.data_as(_I64P), n, *args, res.ctypes.data_as(ptr))
    del keep
    return res


def gather_rrc(data: np.ndarray, idx: np.ndarray, plan, *,
               out: Optional[np.ndarray] = None) -> Optional[np.ndarray]:
    """``out[i] = random_resized_crop(data[idx[i]], plan[i])``, the
    ``ImageNetAugment`` transform, bit-equal to its numpy ``apply``:
    ``plan`` an ``RRCPlan`` (crop boxes and flips), each box checked to lie
    in the image. None when the library is not available."""
    lib = load()
    if lib is None or data.ndim != 4:
        return None
    if data.dtype == np.uint8:
        fn, ptr = lib.fedloader_gather_rrc_u8, _U8P
    elif data.dtype == np.float32:
        fn, ptr = lib.fedloader_gather_rrc, _F32P
    else:
        return None
    data, idx = _checked(data, idx)
    n = int(idx.shape[0])
    _, h, w, c = data.shape
    ys, xs, hs, ws = (np.ascontiguousarray(a, np.int32)
                      for a in (plan.ys, plan.xs, plan.hs, plan.ws))
    flips = np.ascontiguousarray(plan.flips, np.uint8)
    if not all(len(a) == n for a in (ys, xs, hs, ws, flips)):
        raise ValueError(f"plan arrays must match idx length {n}")
    # the C loop reads rows ys + hs - 1 and columns xs + ws - 1 unchecked
    if n and (int(hs.min()) < 1 or int(ws.min()) < 1 or int(ys.min()) < 0
              or int(xs.min()) < 0
              or int((ys.astype(np.int64) + hs).max()) > h
              or int((xs.astype(np.int64) + ws).max()) > w):
        raise IndexError("RRC crop box out of image bounds")
    res = _out(out, (n, h, w, c), data.dtype)
    fn(data.ctypes.data_as(ptr), data.shape[0], h, w, c,
       idx.ctypes.data_as(_I64P), n, ys.ctypes.data_as(_I32P),
       xs.ctypes.data_as(_I32P), hs.ctypes.data_as(_I32P),
       ws.ctypes.data_as(_I32P), flips.ctypes.data_as(_U8P),
       res.ctypes.data_as(ptr))
    return res


def gather_rows(data: np.ndarray, idx: np.ndarray, *,
                out: Optional[np.ndarray] = None) -> Optional[np.ndarray]:
    """``out[i] = data[idx[i]]`` for any array of fixed-size rows; None when
    the library is not available."""
    lib = load()
    if lib is None or data.dtype == object:
        return None
    data, idx = _checked(data, idx)
    n = int(idx.shape[0])
    row_bytes = data.dtype.itemsize * int(np.prod(data.shape[1:],
                                                  dtype=np.int64))
    res = _out(out, (n,) + data.shape[1:], data.dtype)
    lib.fedloader_gather_rows(data.ctypes.data_as(ctypes.c_char_p),
                              idx.ctypes.data_as(_I64P), n, row_bytes,
                              res.ctypes.data_as(ctypes.c_char_p))
    return res
