"""The port's invariant linter (``commefficient_tpu_torch/analysis/``)
held against the reference's (``commefficient_tpu/analysis/``) and
against the block program the scan engine captures.

Four families:

  1. shared meaning, identical findings: for ``exception-hygiene``,
     ``registry-dispatch``, the pragma grammar, ``parse`` and the CLI
     contract, the same fixture tree goes through the reference's
     ``run_analyzers``/``main`` and the port's, which must give the same
     ``(rule, path, line)`` lists and the same summary keys;
  2. the three rules read for torch fire on planted violations and stay
     quiet on their clean twins: ``traced-purity`` (each host read
     reached from a ``torch.cuda.graph`` root and from a
     ``raw_round_idx_fn`` root, through a helper, a builder closure, a
     method; the ``graph_capturing`` guard prunes), ``rng-stream``
     (``manual_seed``, global draws, the reference's numpy cases) and
     ``collective-axis`` (a collective outside ``parallel/mesh.py``'s
     counted groups, without ``group=``, with a literal peer);
  3. the port lints clean, its pragmas carry reasons, and the analysis
     package imports neither torch nor the reference;
  4. run-time agreement: for every ``CASES`` entry of
     tests/test_torch_scan_engine.py, every port function that the block
     program enters (the selections in their capture forms, as under
     ``torch.cuda.graph``) is in ``traced-purity``'s reachable set.

Fixtures are written to ``tmp_path`` as miniature packages and analyzed
by AST only: nothing in them is imported or run.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from commefficient_tpu.analysis import run_analyzers as ref_run
from commefficient_tpu.analysis.__main__ import main as ref_main
from commefficient_tpu_torch.analysis import (
    PackageIndex,
    analyzer_registry,
    run_analyzers,
)
from commefficient_tpu_torch.analysis import purity
from commefficient_tpu_torch.analysis.__main__ import main as cli_main
from commefficient_tpu_torch.analysis.core import PACKAGE_ROOT

RULES = {"traced-purity", "rng-stream", "collective-axis",
         "registry-dispatch", "exception-hygiene"}
ROOT = Path(__file__).resolve().parents[1]


def _write(root, files):
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        if isinstance(src, bytes):
            p.write_bytes(src)
        else:
            p.write_text(src)
    return root


def _lint(tmp_path, files, rules=None, run=run_analyzers):
    root = _write(tmp_path / "fixpkg", files)
    findings, _ = run(root=root, rules=rules)
    return findings


def _keys(findings):
    return [(f.rule, f.path, f.lineno) for f in findings]


# ---------------------------------------------------------------------------
# 1. shared meaning: the same findings as the reference
# ---------------------------------------------------------------------------

SHARED = {
    # exception-hygiene: bare and swallowed broad excepts; a narrow
    # swallow and a chained re-raise stay legal
    "exception_hygiene": ({"mod.py": (
        "def f():\n"
        "    try:\n"
        "        g()\n"
        "    except:\n"
        "        pass\n"
        "    try:\n"
        "        g()\n"
        "    except Exception:\n"
        "        pass\n"
        "    try:\n"
        "        g()\n"
        "    except (ImportError, AttributeError):\n"
        "        pass  # narrow swallow: author named what can happen\n"
        "    try:\n"
        "        g()\n"
        "    except Exception as e:\n"
        "        raise RuntimeError('ctx') from e\n"
    )}, [("exception-hygiene", "mod.py", 4),
         ("exception-hygiene", "mod.py", 8)]),
    # registry-dispatch: outside the home package, and the home package
    # dispatching on its own family
    "registry_dispatch": ({
        "train/loop.py": (
            "def f(cfg):\n"
            "    if cfg.mode == 'sketch':\n"
            "        pass\n"
            "    h = {'fixed': 1}[cfg.control_policy]\n"
            "    match cfg.recover_policy:\n"
            "        case 'retry':\n"
            "            pass\n"
        ),
        "compress/registry.py": (
            "def g(cfg):\n"
            "    if cfg.mode == 'sketch':\n"
            "        pass\n"
        ),
        "control/policy.py": (
            "def h(cfg):\n"
            "    return cfg.control_policy == 'fixed' or cfg.mode == 'x'\n"
        ),
    }, [("registry-dispatch", "control/policy.py", 2),
        ("registry-dispatch", "train/loop.py", 2),
        ("registry-dispatch", "train/loop.py", 4),
        ("registry-dispatch", "train/loop.py", 5)]),
    # the seven pragma cases
    "pragma_suppresses_with_reason": ({"mod.py": (
        "def f():\n"
        "    try:\n"
        "        g()\n"
        "    # lint: allow[exception-hygiene] probe is best-effort\n"
        "    except Exception:\n"
        "        pass\n"
    )}, []),
    "pragma_without_reason": ({"mod.py": (
        "def f():\n"
        "    try:\n"
        "        g()\n"
        "    # lint: allow[exception-hygiene]\n"
        "    except Exception:\n"
        "        pass\n"
    )}, [("pragma", "mod.py", 4), ("exception-hygiene", "mod.py", 5)]),
    "pragma_unknown_rule": ({"mod.py": (
        "X = 1  # lint: allow[not-a-rule] because reasons\n"
    )}, [("pragma", "mod.py", 1)]),
    "pragma_scopes_to_rule_and_line": ({"mod.py": (
        "def f(cfg):\n"
        "    # lint: allow[exception-hygiene] wrong rule on purpose\n"
        "    a = cfg.mode == 'sketch'\n"
        "    try:\n"
        "        g()\n"
        "    except Exception:\n"
        "        pass\n"
        "    return a\n"
    )}, [("registry-dispatch", "mod.py", 3),
         ("exception-hygiene", "mod.py", 6)]),
    "trailing_pragma_does_not_leak": ({"mod.py": (
        "def f(cfg):\n"
        "    a = cfg.mode == 'x'  "
        "# lint: allow[registry-dispatch] legacy switch\n"
        "    b = cfg.mode == 'y'\n"
        "    return a, b\n"
    )}, [("registry-dispatch", "mod.py", 3)]),
    "pragma_covers_multiline_statement": ({"mod.py": (
        "import numpy as np\n"
        "\n"
        "def f(seed, row):\n"
        "    # lint: allow[rng-stream] deterministic spec-derived tag\n"
        "    rng = np.random.default_rng(\n"
        "        (seed,\n"
        "         0x123)\n"
        "    )\n"
        "    return rng\n"
    )}, []),
    "pragma_in_docstring_is_inert": ({"mod.py": (
        '"""Docs: use # lint: allow[no-such-rule] here."""\n'
        "MSG = 'also inert: # lint: allow[zzz]'\n"
    )}, []),
    "parse_error": ({"mod.py": "def broken(:\n"}, [("parse", "mod.py", 0)]),
    "non_utf8": ({"legacy.py": b"# -*- coding: latin-1 -*-\n# caf\xe9\n"
                  b"X = 1\n"}, [("parse", "legacy.py", 0)]),
}


@pytest.mark.parametrize("case", sorted(SHARED))
def test_shared_rules_match_reference(tmp_path, case):
    """The port's findings on a shared-meaning fixture are the reference's
    (rule, path, line) list, and that list is the expected one."""
    files, want = SHARED[case]
    ours = _keys(_lint(tmp_path / "port", files))
    theirs = _keys(_lint(tmp_path / "ref", files, run=ref_run))
    assert ours == theirs, (ours, theirs)
    assert sorted(ours) == sorted(want), ours


def _summary(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


BAD = {"bad.py": "def f(cfg):\n    return cfg.mode == 'sketch'\n"}
CLI_CASES = {
    "clean": ({"ok.py": "X = 1\n"}, [], 0),
    "violations": (BAD, [], 1),
    "rules_subset_passes": (BAD, ["--rules", "exception-hygiene"], 0),
    "json_flag": (BAD, ["--json"], 1),
    "duplicate_rules_run_once": (
        BAD, ["--rules", "registry-dispatch,registry-dispatch"], 1),
    "unknown_rule": (BAD, ["--rules", "bogus"], 2),
    "empty_rules": (BAD, ["--rules", ""], 2),
    "not_a_directory": (None, ["--root", "/nonexistent-dir-xyz"], 2),
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_contract_matches_reference(tmp_path, capsys, case):
    """Exit codes and the last-line JSON summary (keys, rules, counts,
    findings with their root-prefixed paths) equal the reference's."""
    files, flags, code = CLI_CASES[case]
    argv = list(flags)
    if files is not None:
        argv = ["--root", str(_write(tmp_path / "pkg", files))] + argv
    out = {}
    for name, main in (("port", cli_main), ("ref", ref_main)):
        assert main(argv) == code, name
        lines = capsys.readouterr().out.strip().splitlines()
        out[name] = (json.loads(lines[-1]), len(lines))
    (ours, n_ours), (theirs, n_theirs) = out["port"], out["ref"]
    assert set(ours) == set(theirs) and ours["kind"] == "invariant_lint"
    if "error" in ours:
        assert ours["error"].split(" (known")[0] == \
            theirs["error"].split(" (known")[0]
        return
    for k in ("rules", "files", "findings", "counts", "clean"):
        assert ours[k] == theirs[k], (k, ours[k], theirs[k])
    assert n_ours == n_theirs  # --json: the summary line alone
    if case == "duplicate_rules_run_once":
        assert ours["counts"] == {"registry-dispatch": 1}
        assert ours["rules"] == ["registry-dispatch"]
    if case == "violations":
        assert ours["findings"][0]["path"] == "pkg/bad.py"


def test_cli_root_dot_and_list_rules_match_reference(tmp_path, capsys,
                                                      monkeypatch):
    """``--root .`` keeps the directory's real name as the path prefix;
    ``--list-rules`` lists the reference's five names and exits 0."""
    root = _write(tmp_path / "pkgdot", BAD)
    monkeypatch.chdir(root)
    assert cli_main(["--root", ".", "--json"]) == 1
    ours = _summary(capsys)
    assert ref_main(["--root", ".", "--json"]) == 1
    assert ours["findings"] == _summary(capsys)["findings"]
    assert ours["findings"][0]["path"] == "pkgdot/bad.py"
    assert cli_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in RULES:
        assert rule in out
    s = json.loads(out.strip().splitlines()[-1])
    assert s["listed"] is True and s["clean"] is True
    assert set(s["rules"]) == RULES
    assert set(analyzer_registry()) == RULES
    for mod in analyzer_registry().values():
        assert mod.DESCRIPTION


def test_rng_numpy_cases_match_reference(tmp_path):
    """The numpy half of ``rng-stream`` is the reference's: a bare
    ``default_rng()``, a literal seed, a literal tag (also in a
    ``SeedSequence``), the global streams; declared streams stay legal."""
    files = {"mod.py": (
        "import numpy as np\n"
        "import random\n"
        "\n"
        "MY_STREAM = 0xFED51\n"
        "\n"
        "def bad(seed):\n"
        "    a = np.random.default_rng()\n"
        "    b = np.random.default_rng(42)\n"
        "    c = np.random.default_rng((seed, 0x123))\n"
        "    d = np.random.default_rng(np.random.SeedSequence([seed, 7]))\n"
        "    e = np.random.normal(0, 1)\n"
        "    f = random.random()\n"
        "    return a, b, c, d, e, f\n"
        "\n"
        "def good(seed, round_idx):\n"
        "    a = np.random.default_rng((seed, MY_STREAM, round_idx))\n"
        "    b = np.random.default_rng(seed)\n"
        "    return a, b\n"
    )}
    ours = _keys(_lint(tmp_path / "p", files, rules=["rng-stream"]))
    theirs = _keys(_lint(tmp_path / "r", files, rules=["rng-stream"],
                         run=ref_run))
    assert ours == theirs
    assert [ln for _, _, ln in ours] == [7, 8, 9, 10, 11, 12]


# ---------------------------------------------------------------------------
# 2a. traced-purity, read for CUDA-graph capture
# ---------------------------------------------------------------------------

READS = {
    "item": "y = x.item()",
    "tolist": "y = x.tolist()",
    "cpu": "y = x.cpu()",
    "numpy": "y = x.numpy()",
    "nonzero_method": "y = x.nonzero()",
    "nonzero": "y = torch.nonzero(x)",
    "masked_select": "y = torch.masked_select(x, x > 0)",
    "unique": "y = torch.unique(x)",
    "tensor": "y = torch.tensor([1.0, 2.0])",
    "as_tensor": "y = torch.as_tensor(HOST)",
    "synchronize": "y = torch.cuda.synchronize()",
    "float_param": "y = float(x)",
    "bool_param": "y = bool(x)",
    "time": "y = time.perf_counter()",
    "numpy_random": "y = np.random.rand()",
    "stdlib_random": "y = random.random()",
    "print": "y = print(x)",
    "open": "y = open('log')",
}
HEADER = ("import random\n"
          "import time\n"
          "import numpy as np\n"
          "import torch\n"
          "HOST = [1.0]\n")


def _graph_root(body):
    """A capture block calling ``step``, whose line 8 is ``body``."""
    return {"mod.py": HEADER + (
        "def step(x):\n"                                     # 6
        "    z = x + 1\n"                                    # 7
        f"    {body}\n"                                      # 8
        "    return z\n"
        "\n"
        "def capture(g, x):\n"
        "    with torch.cuda.graph(g):\n"
        "        out = step(x)\n"
        "    return out\n"
    )}


def _raw_root(body):
    """``FederatedSession.raw_round_idx_fn``'s inner ``raw`` (a declared
    root), whose line 8 is ``body``."""
    return {"parallel/api.py": HEADER + (
        "class FederatedSession:\n"                          # 6
        "    def raw_round_idx_fn(self):\n"                  # 7
        "        def raw(x):\n"                              # 8
        "            z = x + 1\n"                            # 9
        f"            {body}\n"                              # 10
        "            return z\n"
        "        return raw\n"
    )}


ROOTS = {"graph": (_graph_root, "mod.py", 8),
         "raw_round_idx_fn": (_raw_root, "parallel/api.py", 10)}


@pytest.mark.parametrize("read", sorted(READS))
@pytest.mark.parametrize("root", sorted(ROOTS))
def test_purity_flags_each_read_from_each_root(tmp_path, root, read):
    make, path, line = ROOTS[root]
    hits = _keys(_lint(tmp_path, make(READS[read]), ["traced-purity"]))
    assert hits == [("traced-purity", path, line)], hits


@pytest.mark.parametrize("root", sorted(ROOTS))
def test_purity_clean_twin_is_not_flagged(tmp_path, root):
    """The same roots with a device-only body, an annotated host scalar
    coerced, and a literal coercion: nothing."""
    make = ROOTS[root][0]
    assert not _lint(tmp_path, make("y = int(3) + torch.zeros_like(x)"),
                     ["traced-purity"])


def test_purity_follows_helper_builder_and_method(tmp_path):
    """Reached through a helper two hops down, a builder's returned
    closure called by the block, and a method resolved by name (an
    ``autograd.Function``'s ``apply`` reaching its ``forward``); the
    unreferenced twins of each are not."""
    findings = _lint(tmp_path, {"mod.py": (
        "import torch\n"                                     # 1
        "\n"
        "def deep(x):\n"                                     # 3
        "    return x.item()\n"                              # 4
        "\n"
        "def helper(x):\n"
        "    return deep(x)\n"
        "\n"
        "def lonely(x):\n"
        "    return x.item()\n"                              # 10
        "\n"
        "def make_block(n):\n"
        "    def block(x):\n"
        "        return x.tolist()\n"                        # 14
        "    return block\n"
        "\n"
        "class Enc:\n"
        "    def encode(self, x):\n"
        "        return x.cpu()\n"                           # 19
        "\n"
        "class Tap(torch.autograd.Function):\n"
        "    @staticmethod\n"
        "    def forward(ctx, x):\n"
        "        return x.numpy()\n"                         # 24
        "\n"
        "class Unused:\n"
        "    def decode(self, x):\n"
        "        return x.cpu()\n"                           # 28
        "\n"
        "def capture(g, x, enc):\n"
        "    with torch.cuda.graph(g):\n"
        "        a = helper(x)\n"
        "        b = make_block(2)(x)\n"
        "        c = enc.encode(x)\n"
        "        d = Tap.apply(x)\n"
        "    return a, b, c, d\n"
    )}, ["traced-purity"])
    assert [f.lineno for f in findings] == [4, 14, 19, 24], findings


def test_purity_follows_values_through_parameters_and_fields(tmp_path):
    """The port's round shape: a builder's closure passed to a session's
    constructor, stored on an attribute and called through it by the
    declared ``raw`` root; a loss handed down as a parameter."""
    findings = _lint(tmp_path, {
        "train/entry.py": (
            "from fixpkg.parallel.api import FederatedSession\n"
            "from fixpkg.models import make_loss\n"
            "\n"
            "def main():\n"
            "    a, loss = 1, make_loss()\n"
            "    return FederatedSession(loss)\n"
        ),
        "models.py": (
            "def make_loss():\n"
            "    def loss_fn(x):\n"
            "        return x.item()\n"                      # 3
            "    return loss_fn\n"
            "\n"
            "def host_only(x):\n"
            "    return x.item()\n"                          # 7
        ),
        "parallel/api.py": (
            "def build_round_fn(loss_fn):\n"
            "    def round_fn(x):\n"
            "        return loss_fn(x)\n"
            "    return round_fn\n"
            "\n"
            "class FederatedSession:\n"
            "    def __init__(self, loss_fn):\n"
            "        self.round_fn = build_round_fn(loss_fn)\n"
            "\n"
            "    def raw_round_idx_fn(self):\n"
            "        round_fn = self.round_fn\n"
            "        def raw(x):\n"
            "            return round_fn(x)\n"
            "        return raw\n"
        ),
    }, ["traced-purity"])
    assert [(f.path, f.lineno) for f in findings] == [("models.py", 3)]


def test_purity_ignores_host_code(tmp_path):
    assert not _lint(tmp_path, {"mod.py": (
        "import time\n"
        "import torch\n"
        "\n"
        "def host_loop(x):  # never captured: free to read and time\n"
        "    return time.time(), x.item()\n"
        "\n"
        "def capture(g, x):\n"
        "    with torch.cuda.graph(g):\n"
        "        y = x * 2\n"
        "    return y\n"
    )}, ["traced-purity"])


def test_purity_graph_capturing_guard_prunes(tmp_path):
    """``if graph_capturing(v): return static(v)``: what follows never runs
    under capture; ``if not graph_capturing(v):`` neither; an unguarded
    twin is flagged."""
    findings = _lint(tmp_path, {"mod.py": (
        "import torch\n"                                     # 1
        "from fixpkg.ops.topk import graph_capturing\n"
        "\n"
        "def static(v):\n"
        "    return v * 1\n"
        "\n"
        "def select(v):\n"
        "    if graph_capturing(v):\n"
        "        return static(v)\n"
        "    return torch.nonzero(v)\n"                      # 10
        "\n"
        "def maybe_read(v):\n"
        "    if not graph_capturing(v):\n"
        "        print(v.item())\n"                          # 14
        "    return v\n"
        "\n"
        "def ternary(v):\n"
        "    return v if graph_capturing(v) else v.cpu()\n"  # 18
        "\n"
        "def unguarded(v):\n"
        "    return torch.nonzero(v)\n"                      # 21
        "\n"
        "def capture(g, x):\n"
        "    with torch.cuda.graph(g):\n"
        "        y = select(x) + maybe_read(x) + ternary(x) + unguarded(x)\n"
        "    return y\n"
    )}, ["traced-purity"])
    assert [f.lineno for f in findings] == [21], findings


# ---------------------------------------------------------------------------
# 2b. rng-stream, read for torch
# ---------------------------------------------------------------------------


def test_rng_torch_generators_and_global_draws(tmp_path):
    findings = _lint(tmp_path, {"mod.py": (
        "import torch\n"                                              # 1
        "from fixpkg.parallel.round import dp_seed\n"
        "PROBE_STREAM = 5\n"
        "\n"
        "def bad(shape, t):\n"
        "    g = torch.Generator().manual_seed(3)\n"                  # 6
        "    h = torch.Generator(device='cuda')\n"
        "    h.manual_seed(0)\n"                                      # 8
        "    a = torch.randn(shape)\n"                                # 9
        "    b = torch.rand_like(t)\n"                                # 10
        "    c = torch.randint(0, 5, shape)\n"                        # 11
        "    d = torch.multinomial(t, 1)\n"                           # 12
        "    t.normal_()\n"                                           # 13
        "    t.uniform_(0, 1)\n"                                      # 14
        "    torch.nn.init.trunc_normal_(t)\n"                        # 15
        "    torch.manual_seed(1)\n"                                  # 16
        "    torch.cuda.manual_seed_all(seed_of(t))\n"                # 17
        "    torch.seed()\n"                                          # 18
        "    return g, a, b, c, d\n"
        "\n"
        "def good(seed, key, shape, t):\n"
        "    g = torch.Generator().manual_seed(dp_seed(seed, *key))\n"
        "    h = torch.Generator().manual_seed(PROBE_STREAM)\n"
        "    a = torch.randn(shape, generator=g)\n"
        "    t.normal_(generator=h)\n"
        "    torch.nn.init.trunc_normal_(t, generator=g)\n"
        "    return torch.multinomial(t, 1, generator=g), a\n"
    )}, ["rng-stream"])
    assert [f.lineno for f in findings] == list(range(6, 7)) + list(
        range(8, 19)), findings


# ---------------------------------------------------------------------------
# 2c. collective-axis, read for torch
# ---------------------------------------------------------------------------

MESH = (
    "import torch.distributed as dist\n"                              # 1
    "\n"
    "class CollectiveCounter:\n"
    "    pass\n"
    "\n"
    "class DistributedWorkers:\n"
    "    def __init__(self, group):\n"
    "        self.group = group\n"
    "        self.counter = CollectiveCounter()\n"
    "\n"
    "    def all_reduce_sum(self, t):\n"
    "        dist.all_reduce(t, group=self.group)\n"                  # 12
    "        return t\n"
    "\n"
    "    def shift(self, t, step, out):\n"
    "        dist.batch_isend_irecv([\n"
    "            dist.P2POp(dist.isend, t, (self.rank + step) % self.size,\n"
    "                       group=self.group),\n"
    "            dist.P2POp(dist.irecv, out, 1, group=self.group)])\n"  # 19
    "        return out\n"
    "\n"
    "class Uncounted:\n"
    "    def all_reduce_sum(self, t):\n"
    "        dist.all_reduce(t, group=self.group)\n"                  # 24
    "        return t\n"
    "\n"
    "def loose(t, g):\n"
    "    dist.broadcast(t, 0, group=g)\n"                             # 28
    "    dist.all_gather([t], t)\n"                                   # 29
    "    return t\n"
)


def test_collectives_only_in_counted_group_methods(tmp_path):
    findings = _lint(tmp_path, {
        "parallel/mesh.py": MESH,
        "train/loop.py": (
            "import torch.distributed as dist\n"
            "from functools import partial\n"
            "\n"
            "def f(t, g, attn):\n"
            "    dist.all_reduce(t, group=g)\n"                       # 5
            "    dist.isend(t, dst=1, group=g)\n"                     # 6
            "    return partial(attn, axis_name='seq')\n"             # 7
        ),
    }, ["collective-axis"])
    got = [(f.path, f.lineno, f.message.split(" —")[0]) for f in findings]
    assert got == [
        ("parallel/mesh.py", 19, "integer literal 1 as the peer of "
         "torch.distributed.P2POp"),
        ("parallel/mesh.py", 24, "torch.distributed.all_reduce outside "
         "parallel/mesh.py's counted group methods"),
        ("parallel/mesh.py", 28, "integer literal 0 as the peer of "
         "torch.distributed.broadcast"),
        ("parallel/mesh.py", 28, "torch.distributed.broadcast outside "
         "parallel/mesh.py's counted group methods"),
        ("parallel/mesh.py", 29, "torch.distributed.all_gather outside "
         "parallel/mesh.py's counted group methods"),
        ("parallel/mesh.py", 29, "torch.distributed.all_gather without "
         "group="),
        ("train/loop.py", 5, "torch.distributed.all_reduce outside "
         "parallel/mesh.py's counted group methods"),
        ("train/loop.py", 6, "integer literal 1 as the peer of "
         "torch.distributed.isend"),
        ("train/loop.py", 6, "torch.distributed.isend outside "
         "parallel/mesh.py's counted group methods"),
        ("train/loop.py", 7, "inline axis-name literal 'seq'"),
    ], got


# ---------------------------------------------------------------------------
# 3. the port itself
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_index():
    return PackageIndex(PACKAGE_ROOT)


def test_package_lints_clean(port_index):
    findings, _ = run_analyzers(index=port_index)
    assert not findings, (
        "the port must lint clean (fix the violation or pragma it with a "
        "reason):\n" + "\n".join(
            f.format(prefix="commefficient_tpu_torch/") for f in findings))


def test_package_pragmas_all_carry_reasons(port_index):
    """Every pragma names a known rule and a reason, and the intended
    exemptions are there: the cached device constants of the CIFAR
    prep, the seed-derived hash coefficients, the runner's flush."""
    known = set(analyzer_registry())
    pragmas = [(f.rel, p) for f in port_index.files.values()
               for p in f.pragmas]
    for rel, p in pragmas:
        assert p.rule in known and p.reason, (rel, p)
    by_file = {rel for rel, _ in pragmas}
    assert {"data/cifar.py", "ops/countsketch.py",
            "train/runner.py"} <= by_file


def test_analysis_imports_no_torch_nor_the_reference():
    """Pure stdlib: no module of the analysis package imports torch, jax
    or the reference, and running the CLI loads no torch."""
    for path in sorted((PACKAGE_ROOT / "analysis").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and not node.level else [])
            for n in names:
                assert n.split(".")[0] not in ("torch", "jax",
                                               "commefficient_tpu"), (
                    path.name, n)
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys, commefficient_tpu_torch.analysis.__main__ as m; "
         "print(sorted(k for k in ('torch', 'jax', 'commefficient_tpu') "
         "if k in sys.modules))"],
        capture_output=True, text=True, cwd=ROOT, timeout=60)
    assert r.returncode == 0 and r.stdout.strip() == "[]", r.stdout + \
        r.stderr


# ---------------------------------------------------------------------------
# 4. run-time agreement with the captured block program
# ---------------------------------------------------------------------------

from test_torch_scan_engine import CASES, _build, _lr_fn, data  # noqa: E402,F401


@pytest.fixture(scope="module")
def reach(port_index):
    return purity.reachable_index(index=port_index)


@pytest.mark.parametrize("case", sorted(CASES))
def test_block_program_entries_are_reachable(data, case, reach,  # noqa: F811
                                             monkeypatch):
    """Every port function the block program enters, with the selections
    in their capture forms (``graph_capturing`` true, as under
    ``torch.cuda.graph``), is in ``traced-purity``'s reachable set."""
    from commefficient_tpu_torch.ops import topk as topk_mod
    from commefficient_tpu_torch.pipeline import ScanRounds

    kw = {**CASES[case], "telemetry_level": 1}
    sess, sampler = _build(data, scan_rounds=3, **kw)
    eng = ScanRounds(sess.cfg, sess, sampler, _lr_fn, num_rounds=3,
                     steps_per_epoch=3)
    staged, cids, _ = eng._stage_range(0, 3)
    if eng._dp:
        staged["noise"] = eng._noise(0, cids)
    block = eng._block_fn(3)
    monkeypatch.setattr(topk_mod, "graph_capturing", lambda t: True)
    pkg = str(PACKAGE_ROOT) + "/"
    entered = set()

    def hook(frame, event, arg):
        if event == "call":
            code = frame.f_code
            if code.co_filename.startswith(pkg):
                entered.add((code.co_filename[len(pkg):],
                             code.co_firstlineno, code.co_name))

    sys.setprofile(hook)
    try:
        block(sess.state, staged)
    finally:
        sys.setprofile(None)
    missing, n = purity.unreached_entries(entered, reach)
    assert n > 20 and not missing, (n, missing)
