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
import re
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
build_seconds = None  # wall time of this process's last build, None if cached


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CountSketch "
            "kernels are CUDA C++ built at first use on a CUDA machine"
        )
    return path


def library_path(sources=SOURCES, name: str = "cs") -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in tuple(sources) + HEADERS:
        h.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def compile_library(sources=SOURCES, name: str = "cs") -> Path:
    """Build ``sources`` (under ``csrc/``) into a shared library unless a
    build of the same sources and flags exists; returns its path. The
    ptxas report (registers, shared memory, spills per kernel) is kept in
    the ``.log`` beside it."""
    global build_seconds
    out = library_path(sources, name)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(CSRC / s) for s in sources]]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    build_seconds = time.perf_counter() - t0
    out.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call in this checkout."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(compile_library()))
            P, I64, I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            sigs = {
                "cs_sketch_rows": [P, I64, P, P, P, I64, P, I32, I32, I32,
                                   P],
                "cs_estimate_median": [P, I64, P, I64, P, I32, I32, P],
                "cs_estimate_at": [P, I64, P, I64, I64, P, P, P, P, I32,
                                   I32, P],
                "cs_estimate_range": [P, I64, I64, I64, I64, I64, I64, I64,
                                      P, P, I32, I32, P, P, P, P, P, I32,
                                      I32, P],
                "cs_median_rows": [P, I64, I32, P, P],
                "cs_hash_bits": [P, P, I64, P, I32, I32, P],
            }
            for name, args in sigs.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = I32
            _lib = lib
        return _lib


def _kernel_name(mangled: str) -> str:
    """``_Z21cs_estimate_at_kernelILi5EEv...`` -> ``cs_estimate_at_kernel<5>``
    (the name and integer template arguments of an Itanium-mangled
    function)."""
    m = re.match(r"_Z(\d+)", mangled)
    if not m:
        return mangled
    n = int(m.group(1))
    name = mangled[m.end():m.end() + n]
    args = re.match(r"I((?:Li-?\d+E)+)E", mangled[m.end() + n:])
    if args:
        name += "<" + ",".join(re.findall(r"Li(-?\d+)E", args.group(1))) + ">"
    return name


def ptxas_report(log: Path) -> dict:
    """``{kernel: {"registers", "smem_static_bytes", "spill_stores_bytes",
    "spill_loads_bytes"}}`` from a build's ``.log`` (nvcc ``-Xptxas -v``);
    dynamic shared memory is set at launch and is not in it."""
    out, cur = {}, None
    for line in Path(log).read_text().splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(_Z\w+)", line)
        if m:
            cur = out.setdefault(_kernel_name(m.group(1)), {
                "registers": None, "smem_static_bytes": 0,
                "spill_stores_bytes": 0, "spill_loads_bytes": 0})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores_bytes"] = int(m.group(1))
            cur["spill_loads_bytes"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem_static_bytes"] = int(sm.group(1)) if sm else 0
    return out


def sass_counts(lib: Path) -> dict:
    """``{kernel: SASS instructions}`` of a built library (``cuobjdump
    -sass``, NOPs not counted)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    res = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, check=True)
    out, cur = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = _kernel_name(m.group(1))
            out[cur] = 0
        elif cur and re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", line) \
                and " NOP" not in line:
            out[cur] += 1
    return out
