"""Where K1's time goes, at the main path's geometry, on the card.

    python -m commefficient_tpu_torch.ops.cuda.k1_attribution

Times K1 (``cs_sketch_rows``) at the ResNet-9 FetchSGD geometry (D =
6,573,130, r = 5, c = 500,000, fmix32) with CUDA events (median of 21
samples of 10 back-to-back calls, warm L2), through the library's own
entry point with the tile width set explicitly:

* the tile kernel at tile widths W = 8, 16, 32 strides (the wrapper picks
  32 here), and the gather kernel (W = 0, the design before the tiles);
* each row alone (one launch over that row's tiles: 51 blocks at W = 32)
  beside all five rows (255 blocks), for the tile and gather kernels.

Every variant's table is held bit-equal to the wrapper's. Then the SASS
instruction count of both K1 kernels (``cuobjdump -sass``). The last line
is one JSON object.
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
PROBE_STREAM = 0  # the seed of the probe's random input on the card


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
        raise RuntimeError("k1_attribution times the card; it needs a GPU")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    lib = build.load_library()
    spec = cs.CountSketch(**GEOMETRY)
    gen = torch.Generator(device=dev).manual_seed(PROBE_STREAM)
    v_s = cs._scramble(spec, torch.randn(spec.d, generator=gen, device=dev))
    rows, ptr, off, tile = kern._kernel_geometry(spec, str(dev))
    params = spec.kernel_row_params()

    def run(w, row=None):
        """K1 over all rows, or over one row's tiles (its table row)."""
        if row is None:
            prm, r = rows, spec.r
        else:
            one = params[row]
            prm, r = (ctypes.c_longlong * one.size)(*one.tolist()), 1
        out = torch.empty((r, spec.c_actual), device=dev)
        kern._launch(lib.cs_sketch_rows, v_s.data_ptr(), spec.d_eff,
                     ptr.data_ptr(), off.data_ptr(), out.data_ptr(),
                     spec.c_actual, prm, r, 0, w, 0, 0, kern._stream())
        return out

    want = kern.sketch_rows(spec, v_s)
    for w in (0, 8, 16, 32):
        got = run(w)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K1 at tile width {w} differs")
        for row in range(spec.r):
            if not torch.equal(run(w, row)[0], want[row]):
                raise AssertionError(f"K1 row {row} at width {w} differs")
    ms = {f"W{w}_all_rows": _ms(lambda: run(w)) for w in (8, 16, 32)}
    ms["gather_all_rows"] = _ms(lambda: run(0))
    for row in range(spec.r):
        f = spec._factor(row)
        ms[f"W{tile}_row{row}_f{f}"] = _ms(lambda: run(tile, row))
        ms[f"gather_row{row}_f{f}"] = _ms(lambda: run(0, row))
    sass = build.sass_counts(build.compile_library())
    report = {"card": card, "geometry": GEOMETRY, "tile_strides": tile,
              "tiles_per_row": -(-spec.c_actual // (tile * spec.s)),
              "ms": ms, "sass": {k: v for k, v in sass.items()
                                 if k.startswith("cs_sketch")}}
    print(f"[k1_attribution] ms={json.dumps(ms)}", flush=True)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
