"""The benchmark of the PyTorch and CUDA port (``commefficient_tpu_torch``).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the card this process finds and
prints, as the last line of standard output, one JSON object: ``correct``,
``attempted`` and ``failed`` (the window's rounds, and those whose loss
was not finite), ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` the
``breakdown``, and last ``checks``: each number the correctness
comparison read, beside its limit. The same numbers end standard error.
An earlier line gives the bytes a client sends and receives a round.

It exits non-zero, printing no result, without a CUDA device (or with
fewer than the cell asks for), when it finds ``jax``, ``jaxlib``,
``flax`` or the JAX package ``commefficient_tpu`` loaded once the window
has closed, or when ``BENCHMARK.json`` or the program is missing. Build
and kernel caches stay in fixed directories inside the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "commefficient_tpu")


def _environment() -> None:
    """Caches inside the checkout, at fixed paths; no library may load
    JAX on its own."""
    cache = ROOT / "build" / "bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(cache / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that are JAX or the JAX
    package, compared whole (``commefficient_tpu_torch`` is not
    ``commefficient_tpu``)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them (a
    card set below 700 W runs slower under load)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def _fail(msg: str, code: int = 2) -> None:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    bench_file = ROOT / "BENCHMARK.json"
    if not bench_file.is_file() or not (ROOT / "commefficient_tpu_torch"
                                        ).is_dir():
        _fail("BENCHMARK.json or the program commefficient_tpu_torch/ is "
              "missing from this checkout")
    from benchmark.harness.spec import load_cell

    import torch

    bench = json.loads(bench_file.read_text())
    chips = next(w["chips"] for w in bench["workloads"]
                 if w["name"] == args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        _fail(f"the cell needs {chips} CUDA device(s); found {found}")
    cell = load_cell(args.workload, bench_file)
    from benchmark.harness import bench as harness
    from benchmark.yardstick import bytes_moved

    print(f"card {_card()}", flush=True)
    print("bytes_per_client_round " + json.dumps(
        bytes_moved.per_client_round(cell.config, cell.traffic)),
        flush=True)
    res = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", T_START)
    loaded = forbidden_modules()
    if loaded:
        _fail(f"modules of JAX or the JAX package were loaded: {loaded}", 3)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": res["peak_bytes"]}
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": device}
    if res["profile"] is not None:
        device["busy_s"] = res["profile"]["busy_s"]
        device["window_s"] = res["profile"]["window_s"]
        line["breakdown"] = {"device_ops": res["profile"]["device_ops"],
                             "idle_gaps": res["profile"]["idle_gaps"]}
    line["checks"] = res["checks"]
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
