"""Where K4's time goes, at the sharded main path's geometry, on the card.

    python -m commefficient_tpu_torch.ops.cuda.k4_attribution

Builds ``csrc/k4_probe.cu`` (the arbitrary-index K4 as it stood before its
redesign, and variants of it) and times each at every coordinate of the
ResNet-9 FetchSGD geometry (D = 6,573,130, r = 5, c = 500,000, fmix32),
with CUDA events (median of 21 samples of 10 back-to-back calls, warm L2),
each variant twice in mirrored order (0 1 2 3 6 7 7 6 3 2 1 0) and the two
medians averaged:

* 0: as it was (hardware divisions, 64-bit row constants);
* 1: the same, reading a fixed column of each row (no table traffic);
* 2: divisions by multiplier (``index_math.fast_divisor``), 32-bit;
* 3: 2 with the fixed column;
* 6: 2 with streaming hints on the indices and outputs;
* 7: 6 with the fixed column.

Variants 0, 2 and 6 are held to the plain version exactly. Then the SASS
instruction count of every probe and library kernel (``cuobjdump -sass``)
and the library's ptxas report. The last line is one JSON object.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess

import torch

from commefficient_tpu_torch.ops import countsketch as cs
from commefficient_tpu_torch.ops.cuda import build
from commefficient_tpu_torch.ops.cuda import countsketch as kern

GEOMETRY = dict(d=6_573_130, c=500_000, r=5, band=16, seed=42)
PROBE_STREAM = 5  # the seed of the probe's random table on the card
MODES = (0, 1, 2, 3, 6, 7)
EXACT = (0, 2, 6)


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


def main() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("k4_attribution times the card; it needs a GPU")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    path = build.compile_library(("k4_probe.cu",), "k4probe")
    lib = ctypes.CDLL(str(path))
    P, I64, I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.k4_probe.argtypes = [I32, P, I64, P, I64, P, I64, P, P, P]
    lib.k4_probe.restype = I32

    spec = cs.CountSketch(**GEOMETRY)
    params = spec.kernel_row_params()
    rows = (ctypes.c_longlong * params.size)(*params.reshape(-1).tolist())
    gen = torch.Generator(device=dev).manual_seed(PROBE_STREAM)
    table = torch.randn(spec.table_shape, generator=gen, device=dev)
    idx = torch.arange(spec.d, device=dev)
    inv = kern._inverse_perm(spec, str(dev))
    out = torch.empty(spec.d, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def run(variant):
        rc = lib.k4_probe(variant, table.data_ptr(), spec.c_actual,
                          idx.data_ptr(), spec.d, inv.data_ptr(),
                          spec.sblock, out.data_ptr(), rows, stream)
        if rc:
            raise RuntimeError(f"k4_probe variant {variant}: CUDA error {rc}")

    want = kern.estimate_at_torch(spec, table, idx)
    for variant in EXACT:
        run(variant)
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"k4_probe variant {variant} differs from "
                                 "the plain version")
    samples = {m: [] for m in MODES}
    for variant in MODES + MODES[::-1]:
        samples[variant].append(_ms(lambda: run(variant)))
    ms = {m: sum(v) / len(v) for m, v in samples.items()}
    report = {
        "card": card, "geometry": GEOMETRY, "n": spec.d,
        "ms": {str(m): ms[m] for m in MODES},
        "ms_samples": {str(m): samples[m] for m in MODES},
        "split_ms": {
            "table_reads_as_was": ms[0] - ms[1],
            "divisions": ms[0] - ms[2],
            "table_reads_after_divisions": ms[2] - ms[3],
            "streaming_hints": ms[2] - ms[6],
            "rest_after_all": ms[7]},
        "sass_probe": build.sass_counts(path),
        "sass_library": build.sass_counts(build.compile_library()),
        "ptxas_library": build.ptxas_report(
            build.compile_library().with_suffix(".log")),
    }
    for key in ("ms", "split_ms", "sass_probe", "sass_library"):
        print(f"[k4_attribution] {key}={json.dumps(report[key])}",
              flush=True)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
