"""Where K1's time goes, at a FetchSGD geometry, on the card.

    python -m commefficient_tpu_torch.ops.cuda.k1_attribution \
        [--geometry resnet9|gpt2|fixup_resnet50]

Times K1 (``cs_sketch_rows``) at the named geometry (default ResNet-9's:
D = 6,573,130, r = 5, c = 500,000; GPT-2's D = 124,444,417, c =
5,000,000; FixupResNet-50's D = 25,504,026, c = 1,071,171; fmix32) with
CUDA events (median of 21 samples of 10 back-to-back calls, 5 of 2 at
GPT-2's geometry, warm L2):

* the library's K1 through its wrapper, in the f32 and bf16-operand forms;
* the chunk design of ``csrc/riffle.cu`` (the riffled copies and the
  chunk sums), in both forms, at every geometry (the wrapper takes it
  where the vector outgrows the L2), and its time split by kernel from a
  ``torch.profiler`` trace (``split_by_kernel``);
* the tile kernel (the design ResNet-9 takes), a copy built from
  ``csrc/k1_probe.cu`` as a second library: all rows, each row alone, and
  with a part of its chunk step cut (no load, no sign hash, no
  summation, neither load nor summation), which splits its time into
  load, hash, summation and the rest (set-up, staging stores, barriers);
  its resident blocks a multiprocessor (``cudaOccupancy...``);
* the probe's copy of the chunk sums over rows 1..r-1, whole, without
  its summation and without its copies (``chunk_copies``,
  ``chunk_summation``);
* at ResNet-9's geometry only, the probe's tile kernel at tile widths 8
  and 16 strides and the gather kernel.

Every variant that computes the table is held bit-equal to the wrapper's
first. Then the ptxas reports (registers, static shared memory, spills)
of both libraries' K1 kernels. The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess

import torch

from commefficient_tpu_torch.ops import countsketch as cs
from commefficient_tpu_torch.ops.cuda import build, index_math
from commefficient_tpu_torch.ops.cuda import countsketch as kern

GEOMETRIES = {
    "resnet9": dict(d=6_573_130, c=500_000, r=5, band=16, seed=42),
    "gpt2": dict(d=124_444_417, c=5_000_000, r=5, band=16, seed=42),
    "fixup_resnet50": dict(d=25_504_026, c=1_071_171, r=5, band=16, seed=42),
}
PROBE_STREAM = 0  # the seed of the probe's random input on the card
PROBE = (("k1_probe.cu",), "k1probe")  # build.compile_library's arguments
NO_LOAD, NO_HASH, NO_SUM = 1, 2, 4
MODES = {"tiles": 0, "tiles-load": NO_LOAD, "tiles-hash": NO_HASH,
         "tiles-sum": NO_SUM, "tiles-load-sum": NO_LOAD | NO_SUM}


def _ms(fn, samples: int = 21, calls: int = 10) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def split_by_kernel(fn, calls: int = 5) -> dict:
    """``{kernel name: device ms a call}`` of ``fn`` from a
    ``torch.profiler`` trace of ``calls`` calls (after one warm-up)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = e.cuda_time_total
        if t > 0:
            out[e.key.split("(")[0][:80]] = t / 1e3 / calls
    return out


def load_probe() -> ctypes.CDLL:
    """The probe library (built from ``csrc/k1_probe.cu`` on first use)."""
    lib = ctypes.CDLL(str(build.compile_library(*PROBE)))
    P, I64, I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.k1_probe.argtypes = [I32, I32, P, I64, P, P, P, I64, P, I32, I32,
                             I32, I32, P]
    lib.k1_probe_occupancy.argtypes = [I32, I32, I32, P]
    lib.k1_chunk_probe.argtypes = [I32, P, I64, P, P, P, I64, P, I32, I32,
                                   I32, P]
    lib.k1_probe.restype = lib.k1_probe_occupancy.restype = I32
    lib.k1_chunk_probe.restype = I32
    return lib


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--geometry", choices=sorted(GEOMETRIES),
                    default="resnet9")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("k1_attribution times the card; it needs a GPU")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    geo = GEOMETRIES[args.geometry]
    big = args.geometry == "gpt2"
    timing = dict(samples=5, calls=2) if big else {}
    lib = build.load_library()
    probe = load_probe()
    spec = cs.CountSketch(**geo)
    gen = torch.Generator(device=dev).manual_seed(PROBE_STREAM)
    v_s = cs._scramble(spec, torch.randn(spec.d, generator=gen, device=dev))
    rows, ptr, off = kern._kernel_geometry(spec, str(dev))[:3]
    params = spec.kernel_row_params()
    m = spec.chunk_m
    per = -(-m // index_math.K1_THREADS)
    tile = index_math.sketch_tile_strides(
        [(m, spec.s_row(r), spec.V_row(r)) for r in range(spec.r)])
    stream = kern._stream()

    def smem_at(w):
        return max(index_math.sketch_smem_bytes(m, spec.V_row(r),
                                                w * spec.s_row(r))
                   for r in range(spec.r))

    def old(w, mode=0, row=None):
        """The probe's copy of the tile kernel, all rows or one."""
        if row is None:
            prm, r = rows, spec.r
        else:
            one = params[row]
            prm, r = (ctypes.c_longlong * one.size)(*one.tolist()), 1
        out = torch.empty((r, spec.c_actual), device=dev)
        # a row's parameters carry its bases in the CSR tables
        rc = probe.k1_probe(mode, per, v_s.data_ptr(), spec.d_eff,
                            ptr.data_ptr(), off.data_ptr(), out.data_ptr(),
                            spec.c_actual, prm, r, 0, w, smem_at(w), stream)
        if rc:
            raise RuntimeError(f"k1_probe mode {mode}: CUDA error {rc}")
        return out

    def gather():
        out = torch.empty(spec.table_shape, device=dev)
        kern._launch(lib.cs_sketch_rows, v_s.data_ptr(), spec.d_eff,
                     ptr.data_ptr(), off.data_ptr(), out.data_ptr(),
                     spec.c_actual, rows, spec.r, 0, 0, 0, 0, stream)
        return out

    want = kern.sketch_rows(spec, v_s)
    torch.cuda.synchronize()
    if not torch.equal(old(tile), want):
        raise AssertionError("the probe's tile kernel differs from K1")
    for row in range(spec.r):
        one = old(tile, row=row)
        if not torch.equal(one[0], want[row]):
            raise AssertionError(f"the probe's tile kernel, row {row} "
                                 "alone, differs from K1")
    F32, BF = torch.float32, torch.bfloat16
    cw = index_math.chunk_tile_strides(
        [(m, spec.s_row(r), spec.V_row(r)) for r in range(spec.r)])

    def chunks(operand=F32, table_dtype=F32):
        return kern.launch_sketch_rows(spec, v_s, operand, table_dtype,
                                       "chunks", cw)

    for operand, table_dtype in ((F32, F32), (BF, F32), (F32, BF), (BF, BF)):
        got = chunks(operand, table_dtype)
        old_form = kern.launch_sketch_rows(spec, v_s, operand, table_dtype,
                                           "tiles", tile)
        torch.cuda.synchronize()
        if not torch.equal(got, old_form):
            raise AssertionError(f"the chunk design differs from the tile "
                                 f"kernel ({operand}, {table_dtype})")
    del got, old_form
    ms = {"library": _ms(lambda: kern.sketch_rows(spec, v_s), **timing),
          "library_bf16_operand": _ms(lambda: kern.sketch_rows(
              spec, v_s, BF), **timing),
          "chunks": _ms(chunks, **timing),
          "chunks_bf16_operand": _ms(lambda: chunks(BF), **timing),
          "chunks_bf16_table": _ms(lambda: chunks(F32, BF), **timing),
          "chunks_bf16_both": _ms(lambda: chunks(BF, BF), **timing)}
    by_kernel = {"chunks": split_by_kernel(chunks),
                 "chunks_bf16_operand": split_by_kernel(lambda: chunks(BF))}
    # the chunk sums of rows 1..r-1 alone (the probe's copy of the kernel,
    # from a riffled copy the library made), without their summation and
    # without their copies
    pitch = index_math.riffle_pitch([spec._L_row(r) for r in range(spec.r)])
    riffled = torch.empty((spec.r - 1) * pitch, device=dev)
    full = torch.empty(spec.table_shape, device=dev)
    signs0 = kern.packed_sign_bits(spec, dev, rows=(0,))
    kern._launch(lib.cs_sketch_chunks, v_s.data_ptr(), spec.d_eff,
                 ptr.data_ptr(), off.data_ptr(), full.data_ptr(),
                 spec.c_actual, rows, spec.r, 0, cw, 0, 0, riffled.data_ptr(),
                 pitch, signs0.data_ptr(), stream)
    csmem = max(index_math.chunk_smem_bytes(m, spec.V_row(r))
                for r in range(spec.r))

    def sums(mode):
        out = torch.empty((spec.r - 1, spec.c_actual), device=dev)
        rc = probe.k1_chunk_probe(mode, riffled.data_ptr(), pitch,
                                  ptr.data_ptr(), off.data_ptr(),
                                  out.data_ptr(), spec.c_actual, rows,
                                  spec.r, cw, csmem, stream)
        if rc:
            raise RuntimeError(f"k1_chunk_probe mode {mode}: CUDA error {rc}")
        return out

    if not torch.equal(sums(0), full[1:]):
        raise AssertionError("the probe's chunk sums differ from K1's")
    for name, mode in (("chunk_sums_rows1_4", 0), ("chunk_sums-sum", 4),
                       ("chunk_sums-copy", 8)):
        ms[name] = _ms(lambda: sums(mode), **timing)
    del riffled, full
    for name, mode in MODES.items():
        ms[name] = _ms(lambda: old(tile, mode), **timing)
    for row in range(spec.r):
        ms[f"tiles_row{row}_f{spec._factor(row)}"] = _ms(
            lambda: old(tile, row=row), **timing)
    if args.geometry == "resnet9":
        for w in (8, 16):
            if not torch.equal(old(w), want):
                raise AssertionError(f"tile width {w} differs")
            ms[f"tiles_W{w}"] = _ms(lambda: old(w))
        if not torch.equal(gather(), want):
            raise AssertionError("the gather kernel differs")
        ms["gather"] = _ms(gather)
    occupancy = {}
    for name, mode in MODES.items():
        n = ctypes.c_int(0)
        rc = probe.k1_probe_occupancy(mode, per, smem_at(tile),
                                      ctypes.byref(n))
        if rc:
            raise RuntimeError(f"k1_probe_occupancy: CUDA error {rc}")
        occupancy[name] = n.value
    split = {"load": ms["tiles"] - ms["tiles-load"],
             "sign_hash": ms["tiles"] - ms["tiles-hash"],
             "sum": ms["tiles"] - ms["tiles-sum"],
             "rest": ms["tiles-load-sum"],
             "rows_alone_sum": sum(v for k, v in ms.items()
                                   if k.startswith("tiles_row")),
             "bf16_operand_extra": ms["library_bf16_operand"]
             - ms["library"],
             "chunks_bf16_operand_extra": ms["chunks_bf16_operand"]
             - ms["chunks"],
             "chunk_copies": ms["chunk_sums_rows1_4"] - ms["chunk_sums-copy"],
             "chunk_summation": ms["chunk_sums_rows1_4"]
             - ms["chunk_sums-sum"]}
    ptxas = {k: v for path in (build.compile_library(),
                               build.library_path(*PROBE))
             for k, v in build.ptxas_report(path.with_suffix(".log")).items()
             if k.startswith(("cs_sketch", "cs_riffle", "k1_probe"))}
    report = {"card": card, "geometry": args.geometry, "spec": geo,
              "chunk_m": m, "values_a_thread": per, "tile_strides": tile,
              "design": kern._kernel_geometry(spec, str(dev))[4],
              "chunk_strides": cw, "chunk_smem_bytes": max(
                  index_math.chunk_smem_bytes(m, spec.V_row(r))
                  for r in range(spec.r)),
              "ms_by_kernel": by_kernel,
              "tile_smem_bytes": smem_at(tile),
              "tiles_per_row": -(-spec.c_actual // (tile * spec.s)),
              "resident_blocks_per_sm": occupancy, "ms": ms,
              "split_ms": split, "ptxas": ptxas}
    for key in ("ms", "split_ms", "ms_by_kernel", "resident_blocks_per_sm",
                "ptxas"):
        print(f"[k1_attribution {args.geometry}] {key}="
              f"{json.dumps(report[key])}", flush=True)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
