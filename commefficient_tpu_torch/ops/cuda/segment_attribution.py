"""Where K1's segment form's time goes, on the card.

    python -m commefficient_tpu_torch.ops.cuda.segment_attribution

From the repository root (it takes the geometries and GPT-2's flags from
``chip_smoke.py``).
At the geometries of ``chip_smoke.py``'s segment phase (ResNet-9's largest
and smallest leaves and all 26 leaves of a round; GPT-2's ``wte``, a
768-value bias and all 150 leaves of a round), with fmix32 hashes, it times
the segment form (``cs_sketch_segment``) with CUDA events (median of 5
samples of 2 back-to-back passes over the leaves, warm L2) beside one
``index_add_`` a row of precomputed signed values, and splits the
device time of a pass by kernel under ``torch.profiler`` (three passes):
the small path (``cs_segment_small_kernel``), the scatter pass (keys and the
bucketing by tile, ``cs_segment_scatter_kernel``) and the owner pass
(``cs_segment_owner_kernel``), with each one's launches; and the host's
own time a call, 200 calls of the smallest leaf on the host clock. The
last line is one JSON object.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from commefficient_tpu_torch.ops import countsketch as cs
from commefficient_tpu_torch.ops.cuda import countsketch as kern

KERNELS = ("cs_segment_small_kernel", "cs_segment_scatter_kernel",
           "cs_segment_owner_kernel")
PROBE_STREAM = 3  # the seed of the probe's random vector on the card


def _ms(fn, samples: int = 5, calls: int = 2) -> float:
    for _ in range(2):
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


def _split(fn, calls: int = 3) -> dict:
    """Device ms and launches of each segment kernel a call, over
    ``calls`` calls under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {k: {"ms": 0.0, "launches": 0} for k in KERNELS}
    for e in prof.key_averages():
        for k in KERNELS:
            if k in e.key:
                out[k]["ms"] += e.device_time_total / 1e3 / calls
                out[k]["launches"] += e.count / calls
    return out


def leaf_layout(shapes) -> list:
    """(offset, size) of every leaf of a tree of shapes in the flat
    layout (ravel order)."""
    from commefficient_tpu_torch.ops.param_utils import tree_leaves

    out, off = [], 0
    for _, shape in tree_leaves(shapes):
        out.append((off, math.prod(shape)))
        off += math.prod(shape)
    return out


def cases(resnet9_geometry, gpt2_geometry, gpt2_args) -> dict:
    """``{name: (geometry, [(offset, n), ...])}``: ResNet-9's largest and
    smallest leaves and every leaf of a round; GPT-2's (``gpt2_args``,
    ``gpt2_train``'s flags) ``wte``, a 768-value bias and every leaf of a
    round."""
    from commefficient_tpu_torch.data.personachat import SPECIAL_TOKENS
    from commefficient_tpu_torch.models import init_resnet9
    from commefficient_tpu_torch.models.gpt2 import gpt2_shapes
    from commefficient_tpu_torch.ops.param_utils import tree_leaves
    from commefficient_tpu_torch.train import gpt2_train
    from commefficient_tpu_torch.utils.config import parse_args

    r9 = leaf_layout({p: tuple(t.shape) for p, t in tree_leaves(
        init_resnet9(42))})
    g2 = leaf_layout(gpt2_shapes(gpt2_train.gpt2_config(
        parse_args(gpt2_args, defaults=gpt2_train.DEFAULTS),
        50257 + len(SPECIAL_TOKENS))))
    return {
        "resnet9_largest_leaf": (resnet9_geometry,
                                 [max(r9, key=lambda x: x[1])]),
        "resnet9_smallest_leaf": (resnet9_geometry,
                                  [min(r9, key=lambda x: x[1])]),
        "resnet9_round": (resnet9_geometry, r9),
        "gpt2_wte": (gpt2_geometry, [max(g2, key=lambda x: x[1])]),
        "gpt2_bias_768": (gpt2_geometry, [next(x for x in g2
                                               if x[1] == 768)]),
        "gpt2_round": (gpt2_geometry, g2)}


def main() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("segment_attribution times the card; it needs a "
                           "GPU")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    sys.path.insert(0, str(Path(__file__).resolve().parents[3]))
    import chip_smoke

    geometries = cases(chip_smoke.GEOMETRY, chip_smoke.GPT2_GEOMETRY,
                       chip_smoke.GPT2_ARGS)
    result = {"card": card, "geometries": {}}
    spec = cs.CountSketch(**geometries["resnet9_smallest_leaf"][0])
    table = torch.zeros(spec.table_shape, device=dev)
    vals = torch.ones(10, device=dev)
    for _ in range(20):
        kern.sketch_segment(spec, 0, vals, table)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        kern.sketch_segment(spec, 0, vals, table)
    result["host_us_a_call"] = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    print("host_us_a_call", result["host_us_a_call"], flush=True)
    for name, (geo, segs) in geometries.items():
        spec = cs.CountSketch(**geo)
        gen = torch.Generator(device=dev).manual_seed(PROBE_STREAM)
        v = torch.randn(spec.d, generator=gen, device=dev)
        table = torch.zeros(spec.table_shape, device=dev)

        def run():
            for off, n in segs:
                kern.sketch_segment(spec, off, v[off:off + n], table)

        lo, hi = segs[0][0], segs[-1][0] + segs[-1][1]
        spos = spec.scrambled_pos(torch.arange(lo, hi, device=dev))
        maps = [spec.scrambled_cols_signs(row, spos) for row in range(spec.r)]
        del spos
        src = [v[lo:hi] * sign for _, sign in maps]

        def library():
            for row, (cols, _) in enumerate(maps):
                table[row].index_add_(0, cols, src[row])

        row = dict(leaves=len(segs), n=hi - lo, ms=_ms(run),
                   library_ms=_ms(library), split=_split(run))
        result["geometries"][name] = row
        print(name, json.dumps(row), flush=True)
        del v, table, maps, src
        torch.cuda.empty_cache()
    return result


if __name__ == "__main__":
    print(json.dumps(main()))
