"""Build and bind the port's CUDA kernels (nvcc -> shared library -> ctypes).

At first use the sources under ``csrc/`` are compiled with ``nvcc`` for
``sm_90a`` into ``build/kernels/`` at the repository root (listed in
``.gitignore``), keyed by a hash of the sources and flags, so a fresh
checkout builds them with no step of its own and an edited source rebuilds.
Nothing here runs when the module is imported: the CPU tests import it on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("countsketch.cu",)
HEADERS = ("hash.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of this process's build, None if cached


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CountSketch "
            "kernels are CUDA C++ built at first use on a CUDA machine"
        )
    return path


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libcs_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    global build_seconds
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(CSRC / s) for s in SOURCES]]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    build_seconds = time.perf_counter() - t0
    # ptxas -v prints registers/shared memory/spills per kernel
    out.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call in this checkout."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            P, I64, I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            sigs = {
                "cs_sketch_rows": [P, I64, P, P, P, I64, P, I32, I32, P],
                "cs_estimate_median": [P, I64, P, I64, P, I32, I32, P],
                "cs_estimate_at": [P, I64, P, I64, I64, P, I64, P, P, P,
                                   I32, I32, P],
                "cs_median_rows": [P, I64, I32, P, P],
                "cs_hash_bits": [P, P, I64, P, I32, I32, P],
            }
            for name, args in sigs.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = I32
            _lib = lib
        return _lib
