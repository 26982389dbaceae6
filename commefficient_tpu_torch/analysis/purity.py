"""traced-purity: code a CUDA graph captures must hold no host read and
no host impurity (the reference's ``analysis/purity.py`` read for
CUDA-graph capture).

The scan engine (``pipeline/scan_engine.py``) captures a block of rounds
into one CUDA graph and replays it: the Python runs ONCE, while the
graph is captured, and never again. Whatever that Python did on the
host is frozen into the graph or breaks it:

  * a host read (``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
    ``nonzero``, ``masked_select``, ``unique``, ``torch.cuda.
    synchronize``, ``float(t)`` on a tensor) waits on a value the capture
    has not computed: the capture raises, on the card only, and only on
    the branch that reads;
  * host data made into a tensor (``torch.tensor(...)`` /
    ``torch.as_tensor(...)``: a ``lift_fresh`` and a pageable copy) is
    frozen at its capture-time value — or refused, as the card's first
    capture refused the cutout fill's pageable copy;
  * a wall-clock read, a host draw (stdlib ``random``, ``numpy.random``)
    or I/O (``print``/``input``/``breakpoint``/``open``) runs once at
    capture and never at replay: a replayed block silently differs from
    its per-round twin.

Mechanically: the analyzer builds a package-local reference graph, the
reference's machinery, widened where torch dispatches without a call
the graph could see —

  * **roots**: whatever a ``with torch.cuda.graph(...)`` block calls or
    references (``ScanRounds._capture``'s ``self._block_fn(prog.L)(...)``:
    the block builder and the ``block`` it returns), and
    ``DECLARED_ROOTS``: ``FederatedSession.raw_round_idx_fn`` and its
    inner ``raw``, which the engine reaches through a closure built at
    run time (``self._raw``);
  * **edges** (the reference's): a function *referencing* another
    package function (call, argument, closure) links to it; what a
    builder returns is followed (``grad_one = make_grad_one(...)``, and
    ``maker(...)(x)``); attribute calls and loads resolve by method name
    across the package's classes, minus ``GENERIC_METHODS`` (builtin
    collection/str names, and ``step``, which would tie the round's
    ``state.step`` to every host ``step()``); re-exports through a
    package ``__init__`` resolve to the defining module;
  * **edges** (torch's): a reference to a package class links to the
    methods Python and torch call on it without a visible call
    (``PROTOCOL_METHODS``: ``__init__``/``__post_init__``, an
    ``autograd.Function``'s ``forward``/``backward``/``setup_context``/
    ``vmap``); an attribute load links to a ``@property`` of that name;
    function values flow, to a fixed point, through parameters (every
    function a call site passes to parameter ``p`` is an edge of a body
    that loads ``p``), through attributes (``self.round_fn = round_fn``
    makes every load of ``.round_fn`` an edge to what was stored; a
    ``self.x`` its own class stores and defines no method ``x`` for is
    that field only), through locals assigned more than once, tuple
    returns (``a, loss_fn = build(...)``), ``functools.partial`` and
    outside higher-order calls (``torch.func.grad(f)`` returns what
    calls ``f``).

Branches taken only when no capture is running are pruned, so an eager
read needs no pragma: in ``if graph_capturing(v): return
topk_static(v, k)`` the statements after the ``if`` never run under
capture, nor does the body of ``if not graph_capturing(v):`` (guards:
``graph_capturing``, ``torch.cuda.is_current_stream_capturing``).

Every function reachable from a root is then scanned for:

  * host reads: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
    ``.nonzero()`` / ``torch.nonzero``, ``masked_select``, ``unique``
    (``torch.unique[_consecutive]``), ``torch.tensor`` /
    ``torch.as_tensor``, ``torch.cuda.synchronize`` and any
    ``.synchronize()``, and ``float()`` / ``int()`` / ``bool()`` applied
    directly to a function parameter (a parameter is what holds a device
    tensor; coercions of locally computed host values, and of parameters
    annotated as a host scalar — ``k: int`` — stay legal);
  * wall-clock / host entropy / IO: any call into ``time``,
    ``datetime``, stdlib ``random``, or ``numpy.random``; the builtins
    ``print`` / ``input`` / ``breakpoint`` / ``open``.

Deterministic host work that cannot differ between capture and replay
(a plan memoized before the first capture, a Python-int geometry) is
exempted per line with ``# lint: allow[traced-purity] <reason>``.

``reachable_index`` and ``unreached_entries`` expose the reachable set,
so a run-time hook (``sys.setprofile`` around a capture) can hold every
function the capture really entered against it.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set, Tuple

from commefficient_tpu_torch.analysis.core import (
    PACKAGE_ROOT,
    Finding,
    PackageIndex,
    dotted_path as _core_dotted_path,
    final_name as _final_name,
)

RULE = "traced-purity"
DESCRIPTION = (
    "no host read a CUDA graph cannot hold (.item/.tolist/.cpu/.numpy, "
    "nonzero, masked_select, unique, torch.tensor of host data, "
    "synchronize, a coerced parameter) and no wall-clock/host-rng/print/"
    "IO in code reachable from torch.cuda.graph blocks and the declared "
    "capture roots"
)

# the context managers whose body is captured into a CUDA graph
CAPTURE_CONTEXTS = frozenset({"torch.cuda.graph", "torch.cuda.graphs.graph"})

# (file, qualified name) of functions captured through a closure built at
# run time, which no reference in a capture block names
DECLARED_ROOTS = (
    ("parallel/api.py", "FederatedSession.raw_round_idx_fn"),
    ("parallel/api.py", "FederatedSession.raw_round_idx_fn.raw"),
)

# calls that are true exactly while a capture is running
CAPTURE_GUARDS = frozenset({"graph_capturing",
                            "is_current_stream_capturing"})

# builtin collection/str/array method names excluded from the
# method-name edge rule — linking every captured ``candidates.append(...)``
# to some host class's ``append`` would poison the graph with false paths
# (the reference's list), and ``step``: ``state.step``, a field the round
# reads, would otherwise tie it to every host ``step()`` (the span
# recorder's, the controller's)
GENERIC_METHODS = frozenset({
    "append", "extend", "insert", "remove", "pop", "clear", "copy",
    "count", "index", "sort", "reverse", "get", "items", "keys",
    "values", "setdefault", "update", "add", "discard", "union",
    "join", "split", "rsplit", "strip", "lstrip", "rstrip", "format",
    "startswith", "endswith", "replace", "lower", "upper", "read",
    "write", "close", "flush", "open", "item", "tolist", "astype",
    "reshape", "mean", "sum", "max", "min", "all", "any",
    # flax's model.apply in the reference; here an autograd.Function's
    # ``apply``, whose class reference already links its protocol methods
    "apply", "step",
})

# methods Python or torch calls on a class without a call the graph can
# see: construction, and an autograd.Function's ``apply`` protocol
PROTOCOL_METHODS = ("__init__", "__post_init__", "__new__", "__call__",
                    "forward", "backward", "setup_context", "vmap", "jvp")

BANNED_BUILTINS = frozenset({"print", "input", "breakpoint", "open"})
COERCIONS = frozenset({"float", "int", "bool"})
# tensor methods that read a device value back or size a result by it
READ_METHODS = frozenset({"item", "tolist", "cpu", "numpy", "nonzero",
                          "masked_select", "unique", "unique_consecutive",
                          "synchronize"})
# torch functions of the same kind, and the ones that lift host data
READ_FUNCTIONS = frozenset({"torch.nonzero", "torch.masked_select",
                            "torch.unique", "torch.unique_consecutive",
                            "torch.cuda.synchronize"})
LIFT_FUNCTIONS = frozenset({"torch.tensor", "torch.as_tensor"})

_PROPERTY_DECORATORS = frozenset({"property", "cached_property"})
_ANON = ("<lambda>", "<genexpr>", "<listcomp>", "<dictcomp>", "<setcomp>")


def _banned_module(dotted: str) -> Optional[str]:
    """The impurity family a resolved dotted call path belongs to, or
    None. ``random`` means the stdlib module."""
    top = dotted.split(".", 1)[0]
    if top in ("time", "datetime"):
        return top
    if dotted == "random" or dotted.startswith("random."):
        return "random"
    if dotted == "numpy.random" or dotted.startswith("numpy.random."):
        return "numpy.random"
    return None


@dataclass(eq=False)  # hashed by identity: a node of the graph
class FuncNode:
    """One function (or lambda) in the call graph."""

    qualname: str  # module-rel path + dotted nesting (classes included)
    file_rel: str
    node: ast.AST  # FunctionDef | AsyncFunctionDef | Lambda
    parent: Optional["FuncNode"]
    cls: Optional["ClassInfo"] = None  # the class a method is defined in
    local_defs: Dict[str, "FuncNode"] = field(default_factory=dict)
    params: Tuple[str, ...] = ()
    is_static: bool = False

    @property
    def start(self) -> int:
        """The first line of the def, decorators included (a code
        object's ``co_firstlineno``)."""
        decs = getattr(self.node, "decorator_list", [])
        return min([self.node.lineno] + [d.lineno for d in decs])


@dataclass
class ClassInfo:
    name: str
    methods: Dict[str, FuncNode] = field(default_factory=dict)
    # attributes its methods assign on ``self`` (``self.finish = finish``)
    fields: Set[str] = field(default_factory=set)


@dataclass
class ModuleInfo:
    rel: str
    modname: str  # importable dotted name (root package name + path)
    imports: Dict[str, str] = field(default_factory=dict)  # name -> dotted
    defs: Dict[str, FuncNode] = field(default_factory=dict)  # module level
    classes: Dict[str, ClassInfo] = field(default_factory=dict)
    assigned: Dict[str, List[ast.AST]] = field(default_factory=dict)
    nodes: List[FuncNode] = field(default_factory=list)


def _params_of(node: ast.AST) -> Tuple[str, ...]:
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
        a = node.args
        names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
        if a.vararg:
            names.append(a.vararg.arg)
        if a.kwarg:
            names.append(a.kwarg.arg)
        return tuple(names)
    return ()


def _guard_polarity(test: ast.AST) -> Optional[bool]:
    """True for a capture guard (``graph_capturing(v)``), False for its
    negation, None for any other test."""
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        inner = _guard_polarity(test.operand)
        return None if inner is None else not inner
    if isinstance(test, ast.Call) and _final_name(test.func) in CAPTURE_GUARDS:
        return True
    return None


def _terminates(stmts: List[ast.stmt]) -> bool:
    return bool(stmts) and isinstance(stmts[-1], (ast.Return, ast.Raise))


def _pruned(tree: ast.AST) -> Set[int]:
    """ids of the statements and expressions a capture never runs: the
    arm of a capture guard that is not taken (``if graph_capturing(v):
    ... else: <pruned>``, ``if not graph_capturing(v): <pruned>``), and
    every statement after a taken arm that ends in a return or raise."""
    out: Set[int] = set()
    if not any(isinstance(n, ast.Call) and _final_name(n.func)
               in CAPTURE_GUARDS for n in ast.walk(tree)):
        return out
    for node in ast.walk(tree):
        if isinstance(node, ast.IfExp):
            pol = _guard_polarity(node.test)
            if pol is not None:
                out.add(id(node.orelse if pol else node.body))
        for _, stmts in ast.iter_fields(node):
            if not (isinstance(stmts, list) and stmts
                    and isinstance(stmts[0], ast.stmt)):
                continue
            for k, st in enumerate(stmts):
                if not isinstance(st, ast.If):
                    continue
                pol = _guard_polarity(st.test)
                if pol is None:
                    continue
                taken, other = ((st.body, st.orelse) if pol
                                else (st.orelse, st.body))
                out.update(id(x) for x in other)
                if _terminates(taken):
                    out.update(id(x) for x in stmts[k + 1:])
                    break
    return out


def _body_walk(node: ast.AST, pruned: Set[int] = frozenset()
               ) -> List[ast.AST]:
    """Every node of a function body WITHOUT descending into nested defs
    (each is its own graph node) and without the branches a capture never
    takes (``pruned``); lambdas stay inline — their bodies run in this
    function's dynamic extent."""
    out: List[ast.AST] = []
    stack = ([node.body] if isinstance(node, ast.Lambda)
             else list(ast.iter_child_nodes(node)))
    while stack:
        n = stack.pop()
        if id(n) in pruned:
            continue
        out.append(n)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        stack.extend(ast.iter_child_nodes(n))
    return out


def _decorator_names(fn: ast.AST) -> Set[str]:
    out = set()
    for d in getattr(fn, "decorator_list", []):
        name = _final_name(d.func if isinstance(d, ast.Call) else d)
        if name:
            out.add(name)
    return out


class CallGraph:
    """Package-local reference graph + capture-root reachability."""

    def __init__(self, index: PackageIndex):
        self.index = index
        self.pkg_name = index.root.name
        self.modules: Dict[str, ModuleInfo] = {}
        self.global_defs: Dict[str, FuncNode] = {}  # dotted name -> node
        self.global_classes: Dict[str, ClassInfo] = {}
        self.method_map: Dict[str, List[FuncNode]] = {}
        self.property_map: Dict[str, List[FuncNode]] = {}
        self.node_module: Dict[int, ModuleInfo] = {}  # id(FuncNode) -> mod
        self._walks: Dict[object, List[ast.AST]] = {}
        self._assign_cache: Dict[int, Dict[str, List[ast.AST]]] = {}
        self._lambdas: Dict[int, FuncNode] = {}
        self._pruned: Dict[str, Set[int]] = {}
        self._memo: Dict[tuple, List[FuncNode]] = {}
        self._returns: Dict[int, List[ast.AST]] = {}
        for sf in index.trees():
            self._build_module(sf)
        self.by_modname = {m.modname: m for m in self.modules.values()}
        self._flow()
        self.roots: List[Tuple[FuncNode, str]] = []
        self._collect_roots()

    # ---- construction -------------------------------------------------

    def _modname_for(self, rel: str) -> str:
        parts = rel[:-3].split("/")  # strip .py
        if parts[-1] == "__init__":
            parts = parts[:-1]
        return ".".join([self.pkg_name] + parts) if parts else self.pkg_name

    def _build_module(self, sf) -> None:
        mod = ModuleInfo(rel=sf.rel, modname=self._modname_for(sf.rel))
        self.modules[sf.rel] = mod
        self._pruned[sf.rel] = _pruned(sf.tree)
        # relative-import anchoring differs for packages: in a MODULE,
        # level 1 names its containing package (one climb from modname);
        # in an __init__.py, modname already IS the package
        is_pkg = sf.rel.rsplit("/", 1)[-1] == "__init__.py"

        def visit(node, parent_func, cls: Optional[ClassInfo], prefix):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.Import):
                    for a in child.names:
                        if a.asname:
                            mod.imports[a.asname] = a.name
                        else:
                            mod.imports[a.name.split(".")[0]] = \
                                a.name.split(".")[0]
                elif isinstance(child, ast.ImportFrom):
                    base = child.module or ""
                    if child.level:
                        anchor = mod.modname.split(".")
                        climb = child.level - 1 if is_pkg else child.level
                        if climb:
                            anchor = anchor[:-climb]
                        base = ".".join(anchor + ([base] if base else []))
                    for a in child.names:
                        if a.name == "*":
                            continue
                        mod.imports[a.asname or a.name] = (
                            f"{base}.{a.name}" if base else a.name
                        )
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    qual = f"{prefix}{child.name}"
                    decs = _decorator_names(child)
                    fn = FuncNode(
                        qualname=f"{sf.rel}:{qual}",
                        file_rel=sf.rel, node=child, parent=parent_func,
                        cls=cls,
                        params=_params_of(child),
                        is_static="staticmethod" in decs,
                    )
                    mod.nodes.append(fn)
                    self.node_module[id(fn)] = mod
                    if cls is not None:
                        for sub in ast.walk(child):
                            if isinstance(sub, ast.Attribute) and \
                                    isinstance(sub.ctx, ast.Store) and \
                                    isinstance(sub.value, ast.Name) and \
                                    sub.value.id == "self":
                                cls.fields.add(sub.attr)
                        cls.methods.setdefault(child.name, fn)
                        self.method_map.setdefault(child.name, []).append(fn)
                        if decs & _PROPERTY_DECORATORS:
                            self.property_map.setdefault(
                                child.name, []).append(fn)
                    elif parent_func is not None:
                        parent_func.local_defs[child.name] = fn
                    else:
                        mod.defs[child.name] = fn
                        self.global_defs[f"{mod.modname}.{child.name}"] = fn
                    visit(child, fn, None, f"{qual}.")
                elif isinstance(child, ast.ClassDef):
                    # methods keep the enclosing *function* scope chain
                    # (class bodies are not a lookup scope for names)
                    info = ClassInfo(child.name)
                    if parent_func is None and cls is None:
                        mod.classes[child.name] = info
                        self.global_classes[
                            f"{mod.modname}.{child.name}"] = info
                    visit(child, parent_func, info,
                          f"{prefix}{child.name}.")
                elif isinstance(child, (ast.If, ast.Try, ast.With,
                                        ast.For, ast.While, ast.AsyncWith,
                                        ast.AsyncFor, ast.ExceptHandler)):
                    # defs nested under control flow register in the SAME
                    # scope — recurse with unchanged context
                    visit(child, parent_func, cls, prefix)

        visit(sf.tree, None, None, "")
        mod.assigned = _assignments(self._module_walk(mod))

    def _module_walk(self, mod: ModuleInfo) -> List[ast.AST]:
        w = self._walks.get(mod.rel)
        if w is None:
            w = self._walks[mod.rel] = _body_walk(
                self.index.files[mod.rel].tree, self._pruned[mod.rel])
        return w

    def walk(self, fn: FuncNode) -> List[ast.AST]:
        w = self._walks.get(id(fn))
        if w is None:
            w = self._walks[id(fn)] = _body_walk(
                fn.node, self._pruned[fn.file_rel])
        return w

    # ---- resolution ---------------------------------------------------

    def resolve_name(self, name: str, func: Optional[FuncNode],
                     mod: ModuleInfo) -> Optional[FuncNode]:
        n = func
        while n is not None:
            if name in n.local_defs:
                return n.local_defs[name]
            if name in n.params:
                return None  # parameter shadows everything outward
            n = n.parent
        if name in mod.defs:
            return mod.defs[name]
        dotted = mod.imports.get(name)
        if dotted is not None:
            return self._def(dotted)
        return None

    def _canonical(self, dotted: str) -> str:
        """A package path through re-exports: ``pkg.parallel.X`` is
        ``pkg.parallel.api.X`` when ``parallel/__init__.py`` imports it."""
        for _ in range(5):
            if dotted in self.global_defs or dotted in self.global_classes:
                return dotted
            modname, _, name = dotted.rpartition(".")
            mod = self.by_modname.get(modname)
            if mod is None or name not in mod.imports:
                return dotted
            dotted = mod.imports[name]
        return dotted

    def _def(self, dotted: Optional[str]) -> Optional[FuncNode]:
        return (self.global_defs.get(self._canonical(dotted))
                if dotted is not None else None)

    def _class(self, dotted: Optional[str]) -> Optional[ClassInfo]:
        return (self.global_classes.get(self._canonical(dotted))
                if dotted is not None else None)

    def resolve_class(self, expr: ast.AST, func: Optional[FuncNode],
                      mod: ModuleInfo) -> Optional[ClassInfo]:
        if isinstance(expr, ast.Name):
            n = func
            while n is not None:
                if expr.id in n.params or expr.id in n.local_defs:
                    return None
                n = n.parent
            if expr.id in mod.classes:
                return mod.classes[expr.id]
            dotted = mod.imports.get(expr.id)
            return self._class(dotted) if dotted else None
        if isinstance(expr, ast.Attribute):
            dotted = self.dotted_path(expr, mod)
            if dotted is not None:
                return self._class(dotted)
        return None

    def resolve_func_expr(self, expr: ast.AST, func: Optional[FuncNode],
                          mod: ModuleInfo) -> Optional[FuncNode]:
        if isinstance(expr, ast.Name):
            return self.resolve_name(expr.id, func, mod)
        if isinstance(expr, ast.Attribute):
            dotted = self.dotted_path(expr, mod)
            if dotted is not None:
                return self._def(dotted)
        return None

    def dotted_path(self, expr: ast.AST, mod: ModuleInfo) -> Optional[str]:
        return _core_dotted_path(expr, mod.imports)

    def _lambda_node(self, lam: ast.Lambda, func: Optional[FuncNode],
                     mod: ModuleInfo) -> FuncNode:
        fn = self._lambdas.get(id(lam))
        if fn is None:
            fn = FuncNode(qualname=f"{mod.rel}:<lambda@L{lam.lineno}>",
                          file_rel=mod.rel, node=lam, parent=func,
                          params=_params_of(lam))
            self._lambdas[id(lam)] = fn
            self.node_module[id(fn)] = mod
        return fn

    # ---- function values: parameters, attributes, locals --------------

    def values_of(self, expr: ast.AST, func: Optional[FuncNode],
                  mod: ModuleInfo) -> List[FuncNode]:
        """The package functions ``expr`` may evaluate to (memoized until
        the flow's bindings change)."""
        if expr is None:
            return []
        key = (id(expr), id(func))
        got = self._memo.get(key)
        if got is None:
            self._memo[key] = []  # a cycle through this expr adds nothing
            got = self._memo[key] = self._values(expr, func, mod)
        return got

    def _values(self, expr, func, mod) -> List[FuncNode]:
        if isinstance(expr, _Item):
            return [v for c in self.callees(expr.call, func, mod)
                    for v in self.returns_of(c, item=expr.i)]
        if isinstance(expr, ast.Name):
            return self._name_values(expr.id, func, mod)
        if isinstance(expr, ast.Attribute):
            t = self.resolve_func_expr(expr, func, mod)
            if t is not None:
                return [t]
            if self.dotted_path(expr, mod) is not None:
                return []
            out = list(self.fields.get(expr.attr, ()))
            if not self._own_field(expr, func) and \
                    expr.attr not in GENERIC_METHODS:
                out.extend(self.method_map.get(expr.attr, ()))  # bound
            return out
        if isinstance(expr, ast.Lambda):
            return [self._lambda_node(expr, func, mod)]
        if isinstance(expr, ast.IfExp):
            return (self.values_of(expr.body, func, mod)
                    + self.values_of(expr.orelse, func, mod))
        if isinstance(expr, ast.BoolOp):
            return [v for e in expr.values
                    for v in self.values_of(e, func, mod)]
        if isinstance(expr, ast.Call):
            if _final_name(expr.func) == "partial" and expr.args:
                return self.values_of(expr.args[0], func, mod)
            callees = self.callees(expr, func, mod)
            if not callees:
                # an outside higher-order call (``torch.func.grad(f)``,
                # ``torch.func.vmap(f)``) returns what calls its arguments
                return [v for a in expr.args + [k.value for k in expr.keywords]
                        for v in self.values_of(a, func, mod)]
            out = []
            for callee in callees:
                out.extend(self.returns_of(callee))
            return out
        return []

    def _name_values(self, name: str, func: Optional[FuncNode],
                     mod: ModuleInfo) -> List[FuncNode]:
        """What a name may hold, from the nearest scope that binds it: a
        def, every value assigned to it there (any number of
        assignments: ``v = maker(...)`` gives what ``maker`` returns), and
        for a parameter every function a call site passes to it."""
        n = func
        while n is not None:
            if name in n.local_defs:
                return [n.local_defs[name]]
            rhs = self._assigned(n).get(name)
            if rhs or name in n.params:
                out = [v for e in rhs or ()
                       for v in self.values_of(e, n, mod)]
                if name in n.params:
                    out.extend(self.bindings.get((id(n), name), ()))
                return out
            n = n.parent
        if name in mod.defs:
            return [mod.defs[name]]
        if name in mod.assigned:
            return [v for e in mod.assigned[name]
                    for v in self.values_of(e, None, mod)]
        dotted = mod.imports.get(name)
        t = self._def(dotted) if dotted is not None else None
        return [t] if t is not None else []

    def _assigned(self, fn: FuncNode) -> Dict[str, List[ast.AST]]:
        out = self._assign_cache.get(id(fn))
        if out is None:
            out = self._assign_cache[id(fn)] = _assignments(self.walk(fn))
        return out

    def returns_of(self, fn: FuncNode,
                   item: Optional[int] = None) -> List[FuncNode]:
        """The functions ``fn`` may return (``item``: element ``item`` of
        a returned tuple, for ``a, b = fn(...)``)."""
        mod = self.node_module[id(fn)]
        rets = self._returns.get(id(fn))
        if rets is None:
            rets = self._returns[id(fn)] = [
                sub.value for sub in self.walk(fn)
                if isinstance(sub, ast.Return) and sub.value is not None]
        out = []
        for v in rets:
            if isinstance(v, ast.Tuple):
                if item is None or item >= len(v.elts):
                    continue
                v = v.elts[item]
            elif item is not None:
                continue
            out.extend(self.values_of(v, fn, mod))
        return out

    def callees(self, call: ast.Call, func: Optional[FuncNode],
                mod: ModuleInfo) -> List[FuncNode]:
        """The package functions a call may enter: a resolved name or
        module path, a class's constructor, or (attribute calls) every
        non-generic method of that name."""
        t = self.resolve_func_expr(call.func, func, mod)
        if t is not None:
            return [t]
        cls = self.resolve_class(call.func, func, mod)
        if cls is not None:
            return [m for k, m in cls.methods.items()
                    if k in ("__init__", "__post_init__")]
        if isinstance(call.func, ast.Attribute) and \
                self.dotted_path(call.func, mod) is None and \
                call.func.attr not in GENERIC_METHODS:
            return list(self.method_map.get(call.func.attr, ()))
        return []

    def _flow(self) -> None:
        """Function values through parameters and attributes, to a fixed
        point: ``bindings[(id(f), p)]`` is every function some call site
        passes to ``f``'s parameter ``p``; ``fields[a]`` every function
        stored as ``x.a = ...``."""
        self.bindings: Dict[Tuple[int, str], Set] = {}
        self.fields: Dict[str, Set] = {}
        binds, stores = [], []  # (key, value expr, scope, module)
        for mod in self.modules.values():
            scopes = [(None, self._module_walk(mod))]
            scopes += [(fn, self.walk(fn)) for fn in mod.nodes]
            for fn, nodes in scopes:
                for sub in nodes:
                    if isinstance(sub, ast.Assign):
                        for t in sub.targets:
                            for target, value in _pairs(t, sub.value):
                                if isinstance(target, ast.Attribute) and \
                                        _may_be_function(value):
                                    stores.append((target.attr, value, fn,
                                                   mod))
                    elif isinstance(sub, ast.Call):
                        binds.extend(self._call_binds(sub, fn, mod))
        for _ in range(10):
            before = (sum(len(v) for v in self.bindings.values())
                      + sum(len(v) for v in self.fields.values()))
            self._memo.clear()
            for attr, value, fn, mod in stores:
                vals = self.values_of(value, fn, mod)
                if vals:
                    self.fields.setdefault(attr, set()).update(vals)
            for key, value, fn, mod in binds:
                vals = self.values_of(value, fn, mod)
                if vals:
                    self.bindings.setdefault(key, set()).update(vals)
            after = (sum(len(v) for v in self.bindings.values())
                     + sum(len(v) for v in self.fields.values()))
            if after == before:
                break
        self._memo.clear()

    def _call_binds(self, call: ast.Call, fn, mod):
        """``((id(callee), param), argument, scope, module)`` for every
        argument of ``call`` that may be a function."""
        args = [a for a in call.args if not isinstance(a, ast.Starred)]
        kws = [(k.arg, k.value) for k in call.keywords if k.arg]
        if not any(_may_be_function(a) for a in args + [v for _, v in kws]):
            return []
        out = []
        for callee in self.callees(call, fn, mod):
            params = callee.params
            if callee.cls is not None and not callee.is_static \
                    and params and params[0] in ("self", "cls"):
                params = params[1:]
            for i, a in enumerate(args):
                if i < len(params) and _may_be_function(a):
                    out.append(((id(callee), params[i]), a, fn, mod))
            for k, v in kws:
                if k in params and _may_be_function(v):
                    out.append(((id(callee), k), v, fn, mod))
        return out

    # ---- roots --------------------------------------------------------

    def _is_capture_context(self, item: ast.withitem,
                            mod: ModuleInfo) -> bool:
        ctx = item.context_expr
        if not isinstance(ctx, ast.Call):
            return False
        dotted = self.dotted_path(ctx.func, mod)
        return dotted in CAPTURE_CONTEXTS

    def _collect_roots(self) -> None:
        seen = set()

        def add(fn: FuncNode, why: str):
            if fn is not None and id(fn) not in seen:
                seen.add(id(fn))
                self.roots.append((fn, why))

        for mod in self.modules.values():
            scopes = [(None, self._module_walk(mod))]
            scopes += [(fn, self.walk(fn)) for fn in mod.nodes]
            for fn, nodes in scopes:
                for sub in nodes:
                    if isinstance(sub, (ast.With, ast.AsyncWith)) and any(
                            self._is_capture_context(i, mod)
                            for i in sub.items):
                        pruned = self._pruned[mod.rel]
                        body = [n for st in sub.body
                                for n in _body_walk(ast.Module(
                                    body=[st], type_ignores=[]), pruned)]
                        for t in self._edges_of(body, fn, mod):
                            add(t, "torch.cuda.graph block at "
                                   f"{mod.rel}:{sub.lineno}")
        for rel, qual in DECLARED_ROOTS:
            mod = self.modules.get(rel)
            for fn in (mod.nodes if mod is not None else ()):
                if fn.qualname == f"{rel}:{qual}":
                    add(fn, "declared capture root")

    # ---- edges + reachability -----------------------------------------

    def _class_protocol(self, cls: ClassInfo) -> List[FuncNode]:
        return [cls.methods[m] for m in PROTOCOL_METHODS
                if m in cls.methods]

    def _edges_of(self, nodes: Iterable[ast.AST], fn: Optional[FuncNode],
                  mod: ModuleInfo) -> List[FuncNode]:
        out, seen = [], set()

        def add(t: Optional[FuncNode]):
            if t is not None and id(t) not in seen and t is not fn:
                seen.add(id(t))
                out.append(t)

        for sub in nodes:
            if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load):
                cls = self.resolve_class(sub, fn, mod)
                if cls is not None:
                    for m in self._class_protocol(cls):
                        add(m)
                    continue
                for t in self.values_of(sub, fn, mod):
                    add(t)
            elif isinstance(sub, ast.Attribute) and \
                    isinstance(sub.ctx, ast.Load):
                # a bare attribute LOAD links through a module path, a
                # class, a property of that name, or what was stored under
                # that attribute; method-name matching is reserved for
                # CALL positions below
                dotted = self.dotted_path(sub, mod)
                if dotted is not None:
                    add(self._def(dotted))
                    cls = self._class(dotted)
                    if cls is not None:
                        for m in self._class_protocol(cls):
                            add(m)
                    continue
                if self._own_field(sub, fn):
                    for t in self.fields.get(sub.attr, ()):
                        add(t)
                    continue
                # a property runs on the load; a method loaded as a value
                # (``map(self._up, ...)``, ``comp.server_update if ... else
                # comp.server_update_sharded``) runs where it is called
                for p in self.property_map.get(sub.attr, ()):
                    add(p)
                if sub.attr not in GENERIC_METHODS:
                    for m in self.method_map.get(sub.attr, ()):
                        add(m)
                for t in self.fields.get(sub.attr, ()):
                    add(t)
            if isinstance(sub, ast.Call):
                if isinstance(sub.func, ast.Call):
                    # maker(...)(...): the returned closure runs too
                    for t in self.values_of(sub.func, fn, mod):
                        add(t)
        return out

    @staticmethod
    def _own_field(expr: ast.Attribute, fn: Optional[FuncNode]) -> bool:
        """``self.x`` in a method of a class that assigns ``self.x`` and
        defines no method ``x``: a field (``_Pending``'s ``self.finish``),
        which no method of that name elsewhere can be."""
        n = fn
        while n is not None and n.cls is None:
            n = n.parent
        return (n is not None and isinstance(expr.value, ast.Name)
                and expr.value.id == "self" and expr.attr in n.cls.fields
                and expr.attr not in n.cls.methods)

    def edges_from(self, fn: FuncNode) -> List[FuncNode]:
        return self._edges_of(self.walk(fn), fn, self.node_module[id(fn)])

    def reachable(self) -> Dict[int, Tuple[FuncNode, str]]:
        """{id(node): (node, provenance)} for every function reachable
        from a capture root; provenance names the root for messages."""
        out: Dict[int, Tuple[FuncNode, str]] = {}
        work = []
        for fn, why in self.roots:
            prov = f"{fn.qualname} [{why}]"
            if id(fn) not in out:
                out[id(fn)] = (fn, prov)
                work.append((fn, prov))
        while work:
            fn, prov = work.pop()
            for nxt in self.edges_from(fn):
                if id(nxt) not in out:
                    out[id(nxt)] = (nxt, prov)
                    work.append((nxt, prov))
        return out


def _may_be_function(expr: ast.AST) -> bool:
    return isinstance(expr, (ast.Name, ast.Attribute, ast.Lambda, ast.Call,
                             ast.IfExp, ast.BoolOp))


def _assignments(nodes: Iterable[ast.AST]) -> Dict[str, List[ast.AST]]:
    """{name: [assigned value, ...]} over a scope's assignments."""
    out: Dict[str, List[ast.AST]] = {}
    for sub in nodes:
        if isinstance(sub, ast.Assign):
            for t in sub.targets:
                for name, value in _pairs(t, sub.value):
                    if isinstance(name, ast.Name):
                        out.setdefault(name.id, []).append(value)
        elif isinstance(sub, (ast.AnnAssign, ast.NamedExpr)) and \
                sub.value is not None and isinstance(sub.target, ast.Name):
            out.setdefault(sub.target.id, []).append(sub.value)
    return out


class _Item:
    """Element ``i`` of what ``call`` returns (``a, b = call``)."""

    def __init__(self, call: ast.Call, i: int):
        self.call, self.i = call, i


def _pairs(target: ast.AST, value: ast.AST):
    """(target, value) pairs of an assignment, tuples unpacked
    elementwise when both sides are tuples of one length, and a tuple
    target of a call paired with the call's returned elements."""
    if isinstance(target, (ast.Tuple, ast.List)):
        if isinstance(value, (ast.Tuple, ast.List)) and \
                len(value.elts) == len(target.elts):
            for t, v in zip(target.elts, value.elts):
                yield from _pairs(t, v)
        elif isinstance(value, ast.Call):
            for i, t in enumerate(target.elts):
                if not isinstance(t, ast.Starred):
                    yield t, _Item(value, i)
        return
    yield target, value


_HOST_SCALARS = frozenset({"int", "float", "bool", "str"})


def _annotation(node: ast.AST, param: str) -> Optional[ast.AST]:
    if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return None
    a = node.args
    for arg in a.posonlyargs + a.args + a.kwonlyargs:
        if arg.arg == param:
            return arg.annotation
    return None


def _host_scalar(ann: Optional[ast.AST]) -> bool:
    """An annotation that declares a Python scalar (``int``,
    ``Optional[int]``, ``float | None``): the parameter holds host data,
    and coercing it reads nothing back."""
    if ann is None:
        return False
    if isinstance(ann, ast.Name):
        return ann.id in _HOST_SCALARS
    if isinstance(ann, ast.Constant):
        return ann.value is None or (isinstance(ann.value, str)
                                     and ann.value in _HOST_SCALARS)
    if isinstance(ann, ast.Subscript) and _final_name(ann.value) == "Optional":
        return _host_scalar(ann.slice)
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
        return _host_scalar(ann.left) and _host_scalar(ann.right)
    return False


def _scan_reached(graph: CallGraph, fn: FuncNode, prov: str,
                  index: PackageIndex) -> List[Finding]:
    mod = graph.node_module[id(fn)]
    sf = index.files[fn.file_rel]
    out = []

    def hit(node, what):
        out.append(sf.finding(
            RULE, node.lineno,
            f"{what} in captured code ({fn.qualname}, reachable from "
            f"capture root {prov})",
        ))

    # parameters that may hold a tensor: not annotated as a host scalar
    param_scope = set()
    n: Optional[FuncNode] = fn
    while n is not None:
        param_scope |= {p for p in n.params
                        if not _host_scalar(_annotation(n.node, p))}
        n = n.parent

    for sub in graph.walk(fn):
        if not isinstance(sub, ast.Call):
            continue
        func = sub.func
        if isinstance(func, ast.Attribute):
            dotted = graph.dotted_path(func, mod)
            if dotted is None:
                if func.attr in READ_METHODS:
                    hit(sub, f"host read .{func.attr}()")
                continue
            fam = _banned_module(dotted)
            if fam is not None:
                hit(sub, f"host-impure call {dotted} ({fam})")
            elif dotted in READ_FUNCTIONS:
                hit(sub, f"host read {dotted}")
            elif dotted in LIFT_FUNCTIONS:
                hit(sub, f"host data lifted by {dotted} (a pageable copy "
                         "a graph freezes)")
            continue
        if not isinstance(func, ast.Name):
            continue
        name = func.id
        # an explicitly imported banned name (`from time import
        # perf_counter`) resolves through the import table
        dotted = mod.imports.get(name)
        if dotted is not None:
            fam = _banned_module(dotted)
            if fam is not None:
                hit(sub, f"host-impure call {dotted} ({fam})")
            elif dotted in READ_FUNCTIONS:
                hit(sub, f"host read {dotted}")
            elif dotted in LIFT_FUNCTIONS:
                hit(sub, f"host data lifted by {dotted}")
            continue
        if graph.resolve_name(name, fn, mod) is not None:
            continue  # package-local call; its body is scanned directly
        if name in BANNED_BUILTINS:
            hit(sub, f"host-impure builtin {name}()")
        elif name in COERCIONS and len(sub.args) == 1 and not sub.keywords \
                and isinstance(sub.args[0], ast.Name) \
                and sub.args[0].id in param_scope:
            hit(sub, f"host read {name}({sub.args[0].id}) on a function "
                     "parameter")
    return out


def analyze(index: PackageIndex) -> List[Finding]:
    graph = CallGraph(index)
    findings: List[Finding] = []
    for fn, prov in graph.reachable().values():
        findings.extend(_scan_reached(graph, fn, prov, index))
    return findings


# ---- the reachable set, for a run-time hook -----------------------------


def reachable_index(root: Optional[Path] = None,
                    index: Optional[PackageIndex] = None):
    """``(reachable, defs, classes)``: the ``(path, first line)`` of every
    reachable def (and lambda), every def's ``(path, first line, last
    line)`` and every class's ``(path, first line)`` — what
    ``unreached_entries`` maps code objects onto."""
    if index is None:
        index = PackageIndex(root if root is not None else PACKAGE_ROOT)
    graph = CallGraph(index)
    reach = {(fn.file_rel, fn.start if not isinstance(fn.node, ast.Lambda)
              else fn.node.lineno)
             for fn, _ in graph.reachable().values()}
    defs = sorted((fn.file_rel, fn.start, fn.node.end_lineno)
                  for mod in graph.modules.values() for fn in mod.nodes)
    classes = {(sf.rel, min([c.lineno] + [d.lineno
                                          for d in c.decorator_list]))
               for sf in index.trees() for c in ast.walk(sf.tree)
               if isinstance(c, ast.ClassDef)}
    return reach, defs, classes


def unreached_entries(entered, reach=None, root: Optional[Path] = None,
                      index: Optional[PackageIndex] = None):
    """The entries of ``entered`` (``(path relative to root, first line,
    code name)`` of each code object a run entered: a ``sys.setprofile``
    hook's ``co_filename``, ``co_firstlineno``, ``co_name``) that the
    rule does not reach, and the number of distinct functions entered.
    A lambda or comprehension counts as the innermost def around it (or
    the lambda itself, when it is a node of the graph); a module or class
    body is not a function and is skipped. ``reach`` is
    ``reachable_index``'s result (computed from ``root``/``index`` when
    not given)."""
    reach, defs, classes = (reach if reach is not None
                            else reachable_index(root, index))
    by_start = {(rel, start) for rel, start, _ in defs}
    missing, functions = [], set()
    for rel, line, name in entered:
        if name == "<module>":
            continue
        key = (rel, line)
        if name.startswith("<"):
            if name == "<lambda>" and key in reach:
                functions.add(key)
                continue
            inner = [(start, rel2) for rel2, start, end in defs
                     if rel2 == rel and start <= line <= end]
            if not inner:
                missing.append((rel, line, name))
                continue
            key = (rel, max(inner)[0])
        elif key not in by_start:
            if key in classes:
                continue  # a class body
            missing.append((rel, line, name))
            continue
        functions.add(key)
        if key not in reach:
            missing.append((rel, line, name))
    return sorted(set(missing)), len(functions)
