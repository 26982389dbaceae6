"""rng-stream: every random stream must be declared and derived (the
reference's ``analysis/rng.py`` read for torch).

The port's randomness is layered — fedsim availability draws, the
client sampler, DP noise, powersgd's fresh ``Q``, the augment plans,
the models' initial weights — and the resume/replay contracts
(resilience/, the scan engine's bit-equal blocks) hold only because each
layer's stream is (a) deterministic given ``cfg.seed`` and (b) disjoint
from every other layer's. The conventions that keep that true:

  * numpy, as in the reference: ``np.random.default_rng((seed, STREAM,
    ...))`` — a tuple-seeded generator whose stream tag is a *declared
    module-level constant* (``fedsim/availability.py``'s
    ``FEDSIM_STREAM``, ``asyncfed/schedule.py``'s ``ASYNC_STREAM``), or
    a generator seeded from a seed variable that the caller derived.
    Never ``default_rng()`` (OS entropy: two replays of the same round
    disagree), never an inline literal seed or stream tag (two modules
    picking the same magic number silently collide, and nothing
    greppable declares the stream exists).
  * torch: a ``torch.Generator`` is seeded by ``manual_seed(<derived
    expr>)`` — ``parallel/round.py``'s ``dp_seed(seed, *key)``, or a
    declared ``*_STREAM`` constant — never by an inline int literal, and
    every draw names its generator (``generator=``): ``torch.randn``
    without one draws from torch's process-global stream, which no
    checkpoint holds and every subsystem shares.
  * never a global stream: ``torch.manual_seed`` / ``torch.cuda.
    manual_seed`` / ``torch.seed`` re-seed state another subsystem
    draws from; ``random.random()`` and ``np.random.normal`` are
    invisible to checkpointing.

The reference's key-reuse check has no torch counterpart: a generator
advances its own state at every draw, so drawing twice from one never
repeats a value.

Violations flagged per call site:

  * ``default_rng()`` with no seed;
  * ``default_rng(<int literal>)`` or a tuple/list seed (also inside a
    ``SeedSequence``) containing a bare int literal;
  * ``<generator>.manual_seed(<int literal>)``;
  * ``torch.manual_seed`` / ``torch.cuda.manual_seed[_all]`` /
    ``torch.seed`` / ``torch.random.manual_seed`` / ``torch.random.seed``;
  * a draw without ``generator=``: ``torch.rand`` / ``randn`` /
    ``randint`` / ``randperm`` / ``normal`` / ``bernoulli`` /
    ``multinomial`` / ``poisson`` / ``rand_like`` / ``randn_like`` /
    ``randint_like``, and the in-place ``Tensor.normal_`` / ``uniform_``
    / ``bernoulli_`` / ``random_`` / ``exponential_`` / ``cauchy_`` /
    ``geometric_`` / ``log_normal_`` (also as ``torch.nn.init.*``);
  * stdlib ``random.*`` and module-level ``np.random.<draw>`` /
    ``np.random.seed``.
"""

from __future__ import annotations

import ast
from typing import List

from commefficient_tpu_torch.analysis.core import (
    Finding,
    PackageIndex,
    dotted_path,
    module_imports,
)

RULE = "rng-stream"
DESCRIPTION = (
    "rng seeds derive from declared stream constants/tuples; torch "
    "generators seeded by manual_seed(<derived expr>); no bare "
    "default_rng(), inline literal seeds, or draws from a global stream"
)

# torch functions that draw from the global stream unless given
# ``generator=`` (resolved as ``torch.<name>``)
TORCH_DRAWS = frozenset({
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial", "poisson", "rand_like", "randn_like", "randint_like",
})
# in-place draws (a Tensor method, or ``torch.nn.init.<name>``): final-name
# match, since the tensor is not a module path
INPLACE_DRAWS = frozenset({
    "normal_", "uniform_", "bernoulli_", "random_", "exponential_",
    "cauchy_", "geometric_", "log_normal_", "trunc_normal_",
})
# re-seeding the process-global streams
GLOBAL_SEEDERS = frozenset({
    "torch.manual_seed", "torch.seed",
    "torch.random.manual_seed", "torch.random.seed",
    "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
    "torch.cuda.seed", "torch.cuda.seed_all",
})

# numpy.random attributes that are NOT the module-level global stream
_NP_RANDOM_OK = frozenset({
    "default_rng", "SeedSequence", "Generator", "BitGenerator", "PCG64",
    "Philox", "SFC64", "MT19937",
})


def _is_int_literal(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return True
    # a negated literal (-1) parses as UnaryOp(USub, Constant)
    return (isinstance(node, ast.UnaryOp)
            and isinstance(node.operand, ast.Constant)
            and isinstance(node.operand.value, int))


def _check_seed_value(sf, seed: ast.AST, out: List[Finding]) -> None:
    """Literal checks on one seed expression — shared by default_rng's
    direct argument and SeedSequence's entropy list, so a literal
    stream tag cannot hide one call deeper."""
    if _is_int_literal(seed):
        out.append(sf.finding(
            RULE, seed.lineno,
            "inline literal seed — declare a module-level stream "
            "constant (e.g. X_STREAM = 0x...) and seed from it",
        ))
    elif isinstance(seed, (ast.Tuple, ast.List)):
        for el in seed.elts:
            if _is_int_literal(el):
                out.append(sf.finding(
                    RULE, el.lineno,
                    "inline literal stream tag in a tuple seed — declare "
                    "a module-level *_STREAM constant so streams are "
                    "greppable and provably disjoint",
                ))


def _check_seed_expr(sf, call: ast.Call, out: List[Finding]) -> None:
    """The seed argument of default_rng."""
    if not call.args and not call.keywords:
        out.append(sf.finding(
            RULE, call.lineno,
            "bare default_rng() draws OS entropy — seed it from cfg.seed "
            "and a declared stream constant so replay/resume stay exact",
        ))
        return
    seed = call.args[0] if call.args else call.keywords[0].value
    _check_seed_value(sf, seed, out)


def _has_generator(call: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in call.keywords)


def analyze(index: PackageIndex) -> List[Finding]:
    findings: List[Finding] = []
    for sf in index.trees():
        imports = module_imports(sf.tree)
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            dotted = dotted_path(func, imports)
            if isinstance(func, ast.Attribute) and dotted is None:
                # a method call on a value: a generator's manual_seed
                # (``torch.Generator(...).manual_seed(s)`` too), a tensor's
                # in-place draw
                if func.attr == "manual_seed" and node.args \
                        and _is_int_literal(node.args[0]):
                    findings.append(sf.finding(
                        RULE, node.lineno,
                        "torch.Generator seeded by an inline int literal "
                        "— seed it from a derived expression (dp_seed(seed, "
                        "...)) or a declared *_STREAM constant",
                    ))
                elif func.attr in INPLACE_DRAWS \
                        and not _has_generator(node):
                    findings.append(sf.finding(
                        RULE, node.lineno,
                        f"in-place draw .{func.attr}() without generator= "
                        "— draws from torch's global stream",
                    ))
                continue
            if dotted is None:
                continue
            if dotted == "numpy.random.default_rng":
                _check_seed_expr(sf, node, findings)
            elif dotted == "numpy.random.SeedSequence":
                # SeedSequence([seed, 0x123]) is the same violation as
                # default_rng((seed, 0x123))
                if node.args:
                    _check_seed_value(sf, node.args[0], findings)
            elif dotted.startswith("numpy.random.") and \
                    dotted.rsplit(".", 1)[-1] not in _NP_RANDOM_OK:
                findings.append(sf.finding(
                    RULE, node.lineno,
                    f"module-level numpy global stream {dotted} — use a "
                    "tuple-seeded default_rng generator instead",
                ))
            elif dotted == "random" or dotted.startswith("random."):
                findings.append(sf.finding(
                    RULE, node.lineno,
                    f"stdlib global rng {dotted} — invisible to "
                    "checkpoint/replay; use a seeded generator",
                ))
            elif dotted in GLOBAL_SEEDERS:
                findings.append(sf.finding(
                    RULE, node.lineno,
                    f"{dotted} re-seeds torch's process-global stream — "
                    "seed a torch.Generator of this stream instead",
                ))
            elif dotted.startswith("torch.") and not _has_generator(node) \
                    and ((dotted.count(".") == 1
                          and dotted[6:] in TORCH_DRAWS)
                         or (dotted.startswith("torch.nn.init.")
                             and dotted.rsplit(".", 1)[-1]
                             in INPLACE_DRAWS)):
                findings.append(sf.finding(
                    RULE, node.lineno,
                    f"{dotted} without generator= draws from torch's "
                    "global stream — pass a seeded torch.Generator",
                ))
    return findings
