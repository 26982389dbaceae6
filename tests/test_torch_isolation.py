"""The port stands alone: nothing under ``commefficient_tpu_torch/``, nor
``chip_smoke.py``, imports ``jax``, ``flax``, the JAX package or the
reference's ``scripts/``.

The GPU machine that runs the port has no JAX, so an import that slipped in
would break it there while every CPU test here still passed. Two checks: a
static one over every source file's AST (one case per file), and a
run-time one that imports every module of the package in a fresh
interpreter and looks at what landed in ``sys.modules``.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "commefficient_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "commefficient_tpu",
             "scripts")
SOURCES = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imported_modules(tree: ast.AST):
    """Every module an AST imports: import statements, plus calls of
    ``__import__`` / ``importlib.import_module`` with a literal name."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and node.args:
            fn = node.func
            name = fn.id if isinstance(fn, ast.Name) else (
                fn.attr if isinstance(fn, ast.Attribute) else "")
            arg = node.args[0]
            if name in ("__import__", "import_module") and isinstance(
                    arg, ast.Constant) and isinstance(arg.value, str):
                yield arg.value


def test_the_scan_sees_the_whole_port():
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    for must in ("chip_smoke.py", "commefficient_tpu_torch/__init__.py",
                 "commefficient_tpu_torch/control/__init__.py",
                 "commefficient_tpu_torch/control/controller.py",
                 "commefficient_tpu_torch/control/ladder.py",
                 "commefficient_tpu_torch/control/policy.py",
                 "commefficient_tpu_torch/resilience/__init__.py",
                 "commefficient_tpu_torch/resilience/guard.py",
                 "commefficient_tpu_torch/resilience/manager.py",
                 "commefficient_tpu_torch/resilience/policy.py",
                 "commefficient_tpu_torch/resilience/vault.py",
                 "commefficient_tpu_torch/clientstore/__init__.py",
                 "commefficient_tpu_torch/clientstore/cache.py",
                 "commefficient_tpu_torch/clientstore/store.py",
                 "commefficient_tpu_torch/clientstore/streamer.py",
                 "commefficient_tpu_torch/asyncfed/__init__.py",
                 "commefficient_tpu_torch/asyncfed/schedule.py",
                 "commefficient_tpu_torch/asyncfed/round.py",
                 "commefficient_tpu_torch/asyncfed/engine.py",
                 "commefficient_tpu_torch/pipeline/cohorts.py",
                 "commefficient_tpu_torch/ops/cuda/countsketch.py",
                 "commefficient_tpu_torch/train/cv_train.py",
                 "commefficient_tpu_torch/train/gpt2_train.py",
                 "commefficient_tpu_torch/models/gpt2.py",
                 "commefficient_tpu_torch/models/generate.py",
                 "commefficient_tpu_torch/models/hf_gpt2.py",
                 "commefficient_tpu_torch/data/personachat.py",
                 "commefficient_tpu_torch/data/emnist.py",
                 "commefficient_tpu_torch/data/imagenet.py",
                 "commefficient_tpu_torch/models/fixup_resnet.py",
                 "commefficient_tpu_torch/parallel/envelope.py",
                 "commefficient_tpu_torch/parallel/fsdp.py",
                 "commefficient_tpu_torch/ops/collectives/"
                 "sparse_allreduce.py",
                 "commefficient_tpu_torch/telemetry/__init__.py",
                 "commefficient_tpu_torch/telemetry/diagnostics.py",
                 "commefficient_tpu_torch/telemetry/flight.py",
                 "commefficient_tpu_torch/telemetry/ledger.py",
                 "commefficient_tpu_torch/telemetry/round_audit.py",
                 "commefficient_tpu_torch/telemetry/spans.py",
                 "commefficient_tpu_torch/telemetry/trace.py",
                 "commefficient_tpu_torch/utils/logging.py",
                 "commefficient_tpu_torch/utils/profiling.py"):
        assert must in names
    assert _forbidden("commefficient_tpu.ops")
    assert _forbidden("jax.numpy") and _forbidden("flax")
    assert _forbidden("scripts.check_telemetry_schema")
    assert not _forbidden("commefficient_tpu_torch.ops")
    assert not _forbidden("jaxtyping_lookalike")


@pytest.mark.parametrize("path", SOURCES,
                         ids=[p.relative_to(ROOT).as_posix() for p in SOURCES])
def test_source_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = sorted({m for m in _imported_modules(tree) if _forbidden(m)})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax_module():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in PACKAGE.rglob("*.py"))
    code = (
        "import importlib, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        f"forbidden = {FORBIDDEN!r}\n"
        "new = [m for m in set(sys.modules) - before\n"
        "       if any(m == f or m.startswith(f + '.') for f in forbidden)]\n"
        "print(sorted(new))\n"
        "sys.exit(1 if new else 0)\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
