"""Where K2's time goes, at a dense FetchSGD geometry, on the card.

    python -m commefficient_tpu_torch.ops.cuda.k2_attribution \
        [--geometry resnet9|gpt2|fixup_resnet50]

Builds ``csrc/k2_probe.cu`` (K2 as it stood before its redesign, and the
redesign's walk with each of its cuts behind a switch) and times, at every
coordinate of the named geometry (default ResNet-9's: D = 6,573,130,
r = 5, c = 500,000; fmix32 unless named), with CUDA events (median of 21
samples of 10 back-to-back calls, 5 of 2 at GPT-2's geometry, warm L2),
each variant twice in mirrored order and the two medians averaged. At
ResNet-9's geometry:

* ``old+unscramble``: the old K2 followed by the torch unscramble (the old
  ``estimate_all``), and ``old``, its kernel alone;
* the ladder, one cut added at a time, each followed by the unscramble
  until the unscramble itself is fused: ``walk`` (tiles of 4096 scrambled
  positions, hardware divisions, hashes in the kernel), ``+multipliers``,
  ``+windows01`` (rows 0-1 staged), ``+slots`` (slot tables in shared
  memory), ``+signs`` (packed sign bits), ``+fused``, then ``+per_tile``
  (the riffle's division and the scramble lookup once per tile, rows 0-1
  staged at compile time: the library's design);
* beside them: ``+windows012@2048`` (rows 0-2 staged, tiles of 2048),
  ``fused@2048``, ``fused-signs`` / ``per_tile-signs`` (signs hashed),
  ``fused-slots`` (slots hashed), ``fused-table`` / ``per_tile-table`` (a
  fixed column: no table traffic), and at poly4 ``per_tile@poly4`` with
  ``-signs`` and ``-slots`` (poly4's hashes in the kernel instead);
* ``library`` (``estimate_median``, also ``library@poly4``) and
  ``k4_range``, K4's range form at every coordinate.

At every geometry also ``library_walk`` (the library's walk, whichever
design the wrapper takes) and ``rows`` and ``rows_nt0``: the row design
of ``csrc/riffle.cu`` with row 0 in its final walk and through its pass
(the wrapper takes the first where the table outgrows the L2 or the
walk's slot tables leave shared memory), held to the
plain version, and its time split by kernel from a ``torch.profiler``
trace. At GPT-2's and FixupResNet-50's geometries (fmix32 only), where
rows 0-1's windows at 4096 positions a tile no longer fit together:
``library``, ``k4_range``, ``+fused`` (the slot tables in shared memory,
no window), ``+fused_row0`` (row 0's window staged), and ``fused-table``,
``fused-slots``, ``fused-signs``; their differences split the time into
the in-place rows' table sectors, the slot-table reads, the sign bits and
the per-coordinate rest.

Every variant but the ``-table`` ones is held to the plain version
exactly first. Then the SASS instructions of every probe and library
kernel (``cuobjdump -sass``: the whole kernel, and the innermost loop that
stores, i.e. per coordinate for the walk kernels) and the ptxas reports.
The last line is one JSON object.
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
from commefficient_tpu_torch.ops.cuda.k1_attribution import split_by_kernel

GEOMETRIES = {
    "resnet9": dict(d=6_573_130, c=500_000, r=5, band=16, seed=42),
    "gpt2": dict(d=124_444_417, c=5_000_000, r=5, band=16, seed=42),
    "fixup_resnet50": dict(d=25_504_026, c=1_071_171, r=5, band=16, seed=42),
}
PROBE_STREAM = 5  # the seed of the probe's random tables on the card
MUL, SLOTS, SIGNS, FUSED, FIXED, PER_TILE, POLY4 = 1, 2, 4, 8, 16, 32, 64
DESIGN = MUL | SLOTS | SIGNS | FUSED
W01, W012 = 48 * 1024, 96 * 1024  # window budgets: rows 0-1, rows 0-2
# name: (walk mode or None for the old kernel, tile positions, window
# budget in bytes, unscramble afterwards, hash family)
VARIANTS = {
    "old+unscramble": (None, 0, 0, True, "fmix32"),
    "old": (None, 0, 0, False, "fmix32"),
    "walk": (0, 4096, 0, True, "fmix32"),
    "+multipliers": (MUL, 4096, 0, True, "fmix32"),
    "+windows01": (MUL, 4096, W01, True, "fmix32"),
    "+windows012@2048": (MUL, 2048, W012, True, "fmix32"),
    "+slots": (MUL | SLOTS, 4096, W01, True, "fmix32"),
    "+signs": (MUL | SLOTS | SIGNS, 4096, W01, True, "fmix32"),
    "+fused": (DESIGN, 4096, W01, False, "fmix32"),
    "+per_tile": (DESIGN | PER_TILE, 4096, W01, False, "fmix32"),
    "fused@2048": (DESIGN, 2048, W01, False, "fmix32"),
    "fused-signs": (DESIGN & ~SIGNS, 4096, W01, False, "fmix32"),
    "fused-slots": (DESIGN & ~SLOTS, 4096, W01, False, "fmix32"),
    "fused-table": (DESIGN | FIXED, 4096, 0, False, "fmix32"),
    "per_tile-signs": (DESIGN & ~SIGNS | PER_TILE, 4096, W01, False,
                       "fmix32"),
    "per_tile-table": (DESIGN | PER_TILE | FIXED, 4096, W01, False,
                       "fmix32"),
    "per_tile@poly4": (DESIGN | PER_TILE, 4096, W01, False, "poly4"),
    "per_tile-signs@poly4": (DESIGN & ~SIGNS | PER_TILE | POLY4, 4096, W01,
                             False, "poly4"),
    "per_tile-slots@poly4": (DESIGN & ~SLOTS | PER_TILE | POLY4, 4096, W01,
                             False, "poly4"),
}
# at GPT-2's and FixupResNet-50's geometries (fmix32): the walk with no
# staged window unless named (the budget stages row 0 alone at GPT-2)
WIDE_VARIANTS = {
    "+fused": (DESIGN, 4096, 0, False, "fmix32"),
    "+fused_row0": (DESIGN, 4096, W01, False, "fmix32"),
    "fused-table": (DESIGN | FIXED, 4096, 0, False, "fmix32"),
    "fused-slots": (DESIGN & ~SLOTS, 4096, 0, False, "fmix32"),
    "fused-signs": (DESIGN & ~SIGNS, 4096, 0, False, "fmix32"),
}


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


PROBE = (("k2_probe.cu",), "k2probe")  # build.compile_library's arguments


def load_probe() -> ctypes.CDLL:
    """The probe library (built from ``csrc/k2_probe.cu`` on first use)."""
    lib = ctypes.CDLL(str(build.compile_library(*PROBE)))
    P, I64, I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.k2_probe_old.argtypes = [P, I64, P, I64, P, P]
    lib.k2_probe_walk.argtypes = [I32, P, I64, P, I64, I64, P, I64, P, I64,
                                  P, I64, I64, I64, P, P, P, P, P]
    lib.k2_probe_old.restype = lib.k2_probe_walk.restype = I32
    return lib


def _plan(spec, device: str, coords: int) -> dict:
    """The library's K2 plan, its tiles and table windows redone at
    ``coords`` scrambled positions a tile when that is not the library's
    tile size (the permutation, slot tables and sign bits are the same)."""
    plan = kern._k2_plan(spec, device)
    if coords == plan["per_tile"]:
        return plan
    b = plan["b"]
    blocks = plan["perm"].cpu().numpy()
    wstart, wlen = index_math.range_windows(
        blocks, spec.inverse_block_perm(), b, 0, spec.d, spec.d,
        kern._row_geo(spec), coords // b)
    return dict(plan, per_tile=coords, ntiles=int(wstart.shape[0]),
                wstart=torch.from_numpy(wstart.astype("int32")).to(device),
                wlen_all=wlen)


def old_k2(lib, spec, table: torch.Tensor, out_s: torch.Tensor) -> None:
    """K2 as it stood before its redesign (fmix32, r = 5): the [d_eff]
    estimates in scrambled order into ``out_s``."""
    rows = kern._kernel_geometry(spec, str(table.device))[0]
    rc = lib.k2_probe_old(table.data_ptr(), spec.c_actual, out_s.data_ptr(),
                          spec.d_eff, rows,
                          torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"k2_probe_old: CUDA error {rc}")


def split(ms: dict) -> dict:
    """The time split from the variants' medians (ms)."""
    if "old" not in ms:  # GPT-2 or FixupResNet-50
        return {
            "table_sectors_in_place": ms["+fused"] - ms["fused-table"],
            "row0_window_staged": ms["+fused"] - ms["+fused_row0"],
            "slot_tables_global_vs_smem": ms["library_walk"] - ms["+fused"],
            "slot_hash_vs_smem_tables": ms["fused-slots"] - ms["+fused"],
            "sign_hash_vs_bits": ms["fused-signs"] - ms["+fused"],
            "rest": ms["fused-table"]}
    return {
        "unscramble_gather": ms["old+unscramble"] - ms["old"],
        "walk": ms["old+unscramble"] - ms["walk"],
        "multipliers": ms["walk"] - ms["+multipliers"],
        "windows01": ms["+multipliers"] - ms["+windows01"],
        "windows012_at_2048": ms["+windows01"] - ms["+windows012@2048"],
        "slot_tables": ms["+windows01"] - ms["+slots"],
        "sign_bits": ms["+slots"] - ms["+signs"],
        "fused_unscramble": ms["+signs"] - ms["+fused"],
        "per_tile": ms["+fused"] - ms["+per_tile"],
        "sign_bits_in_fused": ms["fused-signs"] - ms["+fused"],
        "slot_tables_in_fused": ms["fused-slots"] - ms["+fused"],
        "sign_bits_in_per_tile": ms["per_tile-signs"] - ms["+per_tile"],
        "sign_bits_at_poly4": ms["per_tile-signs@poly4"]
        - ms["per_tile@poly4"],
        "slot_tables_at_poly4": ms["per_tile-slots@poly4"]
        - ms["per_tile@poly4"],
        "table_traffic_in_fused": ms["+fused"] - ms["fused-table"],
        "table_traffic_in_per_tile": ms["+per_tile"] - ms["per_tile-table"],
        "rest_in_per_tile": ms["per_tile-table"]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--geometry", choices=sorted(GEOMETRIES),
                    default="resnet9")
    args = ap.parse_args(argv)
    geometry = GEOMETRIES[args.geometry]
    variants = VARIANTS if args.geometry == "resnet9" else WIDE_VARIANTS
    families = sorted({v[4] for v in variants.values()})
    timing = dict(samples=5, calls=2) if args.geometry == "gpt2" else {}
    if not torch.cuda.is_available():
        raise RuntimeError("k2_attribution times the card; it needs a GPU")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    lib = load_probe()
    path = build.library_path(*PROBE)
    stream = torch.cuda.current_stream().cuda_stream
    specs, tables, wants = {}, {}, {}
    for family in families:
        spec = specs[family] = cs.CountSketch(hash_family=family, **geometry)
        gen = torch.Generator(device=dev).manual_seed(PROBE_STREAM)
        table = tables[family] = torch.randn(spec.table_shape, generator=gen,
                                             device=dev)
        wants[family] = (kern.estimate_median_torch(spec, table),
                         kern._median_network(
                             table[row][cols] * sign for row, (cols, sign)
                             in enumerate(kern._plain_maps(spec, str(dev)))))
    out_s = torch.empty(specs["fmix32"].d_eff, device=dev)
    out = torch.empty(specs["fmix32"].d, device=dev)

    def runner(walk, coords, budget, unscramble, family):
        spec, table = specs[family], tables[family]
        rows = kern._kernel_geometry(spec, str(dev))[0]
        if walk is None:
            def launch():
                old_k2(lib, spec, table, out_s)
                return 0
        else:
            plan = _plan(spec, str(dev), coords)
            # the probe stages any rows: narrowest first within the budget
            staged = index_math.range_staged_rows(plan["wlen_all"], budget)
            woff, wlen, used = [0] * spec.r, [0] * spec.r, 0
            for row in staged:
                woff[row], wlen[row] = used, int(plan["wlen_all"][row])
                used += wlen[row]
            woff = (ctypes.c_int * spec.r)(*woff)
            wlen = (ctypes.c_int * spec.r)(*wlen)
            dst = out if walk & FUSED else out_s

            def launch():
                return lib.k2_probe_walk(
                    walk, table.data_ptr(), spec.c_actual, dst.data_ptr(),
                    spec.d, spec.d_eff, plan["perm"].data_ptr(), plan["b"],
                    plan["slots"].data_ptr(), spec.chunk_m,
                    plan["signs"].data_ptr(), plan["signs"].shape[1],
                    plan["per_tile"], plan["ntiles"],
                    plan["wstart"].data_ptr(), woff, wlen, rows, stream)

        def run():
            rc = launch()
            if rc:
                raise RuntimeError(f"k2 probe walk {walk}: CUDA error {rc}")
            if unscramble:
                return cs._unscramble(spec, out_s)
            return out if walk is not None and walk & FUSED else out_s
        return run

    runs = {name: runner(*v) for name, v in variants.items()}
    fam = {name: v[4] for name, v in variants.items()}
    for family, name in (("fmix32", "library"), ("poly4", "library@poly4")):
        if family not in families:
            continue
        runs[name] = (lambda s, t: lambda: kern.estimate_median(s, t))(
            specs[family], tables[family])
        fam[name] = family
    runs["library_walk"] = lambda: kern.launch_estimate_median(
        specs["fmix32"], tables["fmix32"], torch.float32, "walk")
    fam["library_walk"] = "fmix32"
    for nt, name in ((1, "rows"), (0, "rows_nt0")):
        runs[name] = (lambda n: lambda: kern.launch_estimate_median(
            specs["fmix32"], tables["fmix32"], torch.float32, "rows", n))(nt)
        fam[name] = "fmix32"
    runs["k4_range"] = lambda: kern.estimate_at_range(
        specs["fmix32"], tables["fmix32"], 0, specs["fmix32"].d)
    fam["k4_range"] = "fmix32"
    exact = {}
    for name, run in runs.items():
        got = run()
        torch.cuda.synchronize()
        want, want_s = wants[fam[name]]
        exact[name] = bool(torch.equal(
            got, want_s if got.numel() == want_s.numel() else want))
        if not name.endswith("-table") and not exact[name]:
            raise AssertionError(f"k2 variant {name} differs from the plain "
                                 "version")
    del wants
    names = list(runs)
    samples = {n: [] for n in names}
    for name in names + names[::-1]:
        samples[name].append(_ms(runs[name], **timing))
    ms = {n: sum(v) / len(v) for n, v in samples.items()}
    lib_path = build.compile_library()
    by_kernel = {name: split_by_kernel(runs[name])
                 for name in ("library", "rows", "rows_nt0")}
    report = {
        "design": kern._k2_plan(specs["fmix32"], str(dev))["design"],
        "ms_by_kernel": by_kernel,
        "card": card, "geometry": args.geometry, "spec": geometry,
        "n": geometry["d"], "ms": ms,
        "ms_samples": samples,
        "split_ms": split(ms),
        "exact": exact,
        "sass_probe": build.sass_counts(path),
        "sass_probe_per_coord": build.sass_store_loop_counts(path),
        "sass_library": build.sass_counts(lib_path),
        "sass_library_per_coord": build.sass_store_loop_counts(lib_path),
        "ptxas_library": build.ptxas_report(lib_path.with_suffix(".log")),
        "ptxas_probe": build.ptxas_report(path.with_suffix(".log")),
    }
    for key in ("ms", "split_ms", "ms_by_kernel", "sass_probe",
                "sass_probe_per_coord",
                "sass_library_per_coord", "ptxas_probe"):
        print(f"[k2_attribution {args.geometry}] "
              f"{key}={json.dumps(report[key])}",
              flush=True)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
