"""Build and bind the port's CUDA kernels (nvcc -> shared library -> ctypes).

At first use the sources under ``csrc/`` are compiled with ``nvcc`` for
``sm_90a`` into ``build/kernels/`` at the repository root (listed in
``.gitignore``), keyed by a hash of the sources and flags, so a fresh
checkout builds them with no step of its own and an edited source rebuilds.
Each source is compiled by its own ``nvcc``, all started together, and the
objects are linked into one library.
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
SOURCES = ("countsketch.cu", "segment.cu")
HEADERS = ("common.cuh", "hash.cuh", "layout.cuh")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
build_seconds = {}  # library name -> wall time of this process's nvcc run


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
    build of the same sources and flags exists; returns its path. Each
    source is compiled to an object by its own ``nvcc`` process, all
    started together, then one ``nvcc -shared`` links them. The ptxas
    report (registers, shared memory, spills per kernel) is kept in the
    ``.log`` beside it."""
    out = library_path(sources, name)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [out.with_name(f"{out.stem}.{Path(s).stem}.{tag}.o")
            for s in sources]
    t0 = time.perf_counter()
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in ([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o),
                          str(CSRC / s)] for s, o in zip(sources, objs))]
    log, failed = [], []
    for cmd, proc in procs:
        stdout, stderr = proc.communicate()
        log.append(" ".join(cmd) + "\n" + stdout + stderr)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode}):\n{stderr}")
    tmp = out.with_suffix(f".{tag}")
    if not failed:
        cmd = [_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(cmd, capture_output=True, text=True,
                             check=False)
        log.append(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(f"link ({res.returncode}):\n{res.stderr}")
    build_seconds[name] = time.perf_counter() - t0
    out.with_suffix(".log").write_text("".join(log))
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
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
                                   I32, I32, P],
                "cs_sketch_segment": [P, I64, I64, P, P, I64, I64, P, P,
                                      I64, P, I32, I32, P],
                "cs_estimate_median": [P, I64, P, I64, I64, P, I64, I64, I64,
                                       P, I64, I32, P, I64, P, I32, P, P,
                                       P, I32, I32, P],
                "cs_estimate_at": [P, I64, P, I64, I64, P, P, P, P, I32,
                                   I32, I32, P],
                "cs_estimate_range": [P, I64, I64, I64, I64, I64, I64, I64,
                                      P, P, I32, I32, P, P, P, P, P, I32,
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


def _template_args(s: str):
    """The template arguments at the start of a mangled tail ``I...E``:
    integers, bools (``Lb1E`` reads ``true``), ``float`` and named types
    (``13__nv_bfloat16``); None for anything else."""
    if not s.startswith("I"):
        return None
    i, vals = 1, []
    while i < len(s) and s[i] != "E":
        m = re.match(r"L([ib])(-?\d+)E", s[i:])
        if m:
            t, v = m.groups()
            vals.append(v if t == "i" else ("true" if v == "1" else "false"))
            i += m.end()
            continue
        if s[i] == "f":
            vals.append("float")
            i += 1
            continue
        m = re.match(r"\d+", s[i:])
        if not m:
            return None
        n, start = int(m.group()), i + m.end()
        vals.append(s[start:start + n])
        i = start + n
    return vals


def _kernel_name(mangled: str) -> str:
    """``_Z21cs_estimate_at_kernelILi5EfEv...`` ->
    ``cs_estimate_at_kernel<5,float>`` (the name and template arguments of
    an Itanium-mangled function)."""
    m = re.match(r"_Z(\d+)", mangled)
    if not m:
        return mangled
    n = int(m.group(1))
    name = mangled[m.end():m.end() + n]
    args = _template_args(mangled[m.end() + n:])
    if args:
        name += "<" + ",".join(args) + ">"
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


def _sass(lib: Path) -> dict:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    res = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, check=True)
    return parse_sass(res.stdout)


def parse_sass(text: str) -> dict:
    """``{kernel: [SASS instruction lines]}`` from ``cuobjdump -sass``
    output (NOPs dropped), with each label line (``.L_x_N:``) kept in place
    as ``("label", name)``."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out.setdefault(_kernel_name(m.group(1)), [])
            continue
        if cur is None:
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            cur.append(("label", m.group(1)))
        elif re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", line) \
                and " NOP" not in line:
            cur.append(line)
    return out


def sass_counts(lib: Path) -> dict:
    """``{kernel: SASS instructions}`` of a built library (NOPs not
    counted)."""
    return {k: sum(isinstance(x, str) for x in v)
            for k, v in _sass(lib).items()}


def sass_store_loop_counts(lib: Path) -> dict:
    """``{kernel: SASS instructions}`` of the innermost loop (a backward
    branch to a label) that holds a global store, per kernel of a built
    library: for a kernel whose threads loop over their coordinates, the
    static instructions per coordinate. None where no loop stores."""
    return store_loop_counts(_sass(lib))


def store_loop_counts(sass: dict) -> dict:
    """``sass_store_loop_counts`` of ``parse_sass`` output."""
    out = {}
    for name, body in sass.items():
        labels, ins = {}, []
        for x in body:
            if isinstance(x, tuple):
                labels[x[1]] = len(ins)
            else:
                m = re.search(r"/\*([0-9a-f]{4,})\*/", x)
                labels[int(m.group(1), 16)] = len(ins)
                ins.append(x)
        best = None
        for end, line in enumerate(ins):
            # a branch target is a label or an address
            m = re.search(r"BRA(?:\.\S+)?\s+`?\(?(\.L_x_\d+|0x[0-9a-f]+)", line)
            if not m:
                continue
            t = m.group(1)
            start = labels.get(int(t, 16) if t.startswith("0x") else t)
            if start is None or start > end:
                continue
            if any(re.search(r"\bSTG\b|\bSTG\.", x) for x in ins[start:end + 1]):
                size = end - start + 1
                best = size if best is None else min(best, size)
        out[name] = best
    return out
