"""The command exits non-zero and prints no result without a CUDA
device, and in a directory that holds only ``BENCHMARK.json`` and the
benchmark's own files."""

import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
ARGS = ["--workload", "gpt2.sketch", "--seed", "2147483711", "--seconds",
        "1", "--trace", "0"]


def _run(cwd: Path):
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_no_device_no_result():
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_files_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
