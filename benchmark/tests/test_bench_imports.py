"""Nothing a run loads is JAX or the JAX package, compared by whole
top-level names (``commefficient_tpu_torch`` begins with the JAX
package's name and is not it), and the reference and the yardsticks
import nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import run as bench_run

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "commefficient_tpu"}
PROGRAM = "commefficient_tpu_torch"


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _top(name: str) -> str:
    return name.split(".", 1)[0]


def test_whole_name_comparison(monkeypatch):
    fake = dict(sys.modules)
    fake.update({PROGRAM: object(), PROGRAM + ".ops": object(),
                 "jaxtyping": object(), "flaxen": object()})
    for k in [k for k in fake if _top(k) in FORBIDDEN]:
        del fake[k]
    monkeypatch.setattr(sys, "modules", fake)
    assert bench_run.forbidden_modules() == []
    fake["commefficient_tpu.ops"] = object()
    fake["jaxlib"] = object()
    assert bench_run.forbidden_modules() == ["commefficient_tpu", "jaxlib"]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_imports_jax(path):
    assert not {_top(m) for m in _imports(path)} & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted(list((BENCH / "reference").glob("*.py"))
                   + list((BENCH / "yardstick").glob("*.py"))),
    ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_program(path):
    assert all(_top(m) != PROGRAM for m in _imports(path))


def test_a_run_loads_no_jax():
    code = (
        "import sys, json, warnings; warnings.filterwarnings('ignore');"
        f"sys.path.insert(0, {str(ROOT)!r});"
        "from benchmark.tests.cells import tiny, SEED;"
        "from benchmark.harness import bench;"
        "from benchmark.run import forbidden_modules;"
        "r = bench.run(tiny('gpt2.sketch'), SEED, 0.2, False, 'cpu', 0.0);"
        "print(json.dumps([r['correct'], forbidden_modules()]))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, []]
