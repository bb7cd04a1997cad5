"""RetraceSentinel: static checks for the dispatch contracts that keep
the port's control plane at one build per configuration and free of
device-to-host syncs, plus a sibling style pass (monotonic durations,
scoped broad-except hygiene).

The JAX package jits its two dispatch surfaces; the port runs them as
eager torch, cached per configuration, and captures the decision as a
CUDA graph.  ``JIT_CONTRACTS`` declares the port's traced regions:

* ``control/policy.py`` — the decision's CUDA-graph capture:
  ``_DecideStep._capture`` runs ``fn`` and with it ``_step_math`` (and
  its helpers) under ``torch.cuda.graph``;
* ``core/monitor.py`` / ``kernels/monitor/ops.py`` — the fleet dispatch:
  ``run_monitor_fleet`` with its cached plan (``_fleet_plan``, counted
  by ``fleet_dispatch_trace_count``) into ``_fleet_monitor_scan_impl``.

For each contract the checker walks the module-local call graph from
the declared roots (plain calls and ``self.<method>()`` calls) and
flags, inside that traced region:

RS001  unhashable values reaching a cache key or a static argument: a
       mutable default on a parameter of an ``lru_cache``d function, a
       list/dict/set/array literal passed to one or at a key position
       of a step cache (``CACHE_KEYS``), or at a static position of a
       ``jax.jit`` (the JAX package's form, still recognised)
RS002  a Python ``if``/``while``/``assert``/ternary conditioned on a
       tensor's *value*: ``if t``, ``t.any()``, ``t.item()``,
       ``float(t)``, ``int(t)``, ``t.tolist()``.  On the card each is a
       device-to-host sync per dispatch, and under ``torch.cuda.graph``
       an error.  Torch metadata is host-side and allowed: ``.shape``,
       ``.ndim``, ``.dtype``, ``.device``, ``.is_cuda``, ``.stride()``,
       ``.is_contiguous()``, ``.numel()``, ``.dim()``, ``.size()``,
       ``len()``, ``isinstance``, ``is None`` presence checks, and
       the helpers in ``HOST_HELPERS`` that read only metadata
       (``_time_major``, which reads strides)
RS003  a donated buffer read after its dispatch — the donation registry
       (``DONATING_CALLS``) covers ``control_decide(..., donate=True)``
       and the fleet scan's ``donate=True``, whose callees update the
       state's tensors in place (and ``jax.jit(..., donate_argnums=...)``
       results); rebinding the name in the call statement (``state, out
       = step(state, ...)``) is the sanctioned pattern

Style pass (``StylePass``):

ST101  ``time.time()`` call without a ``# wall-clock: <reason>``
       annotation — durations must use ``time.monotonic()``; wall
       clocks are for cross-process timestamps only
ST102  ``except Exception``/bare ``except`` in ``train``/``launch``
       without a ``# crash-containment: <reason>`` annotation
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, FrozenSet, Iterator, List, Optional, Set, Tuple

from .model import PACKAGE, Checker, Finding, Source, dotted_name

# torch metadata, read on the host without touching the device
_STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "device", "is_cuda",
                 "layout", "requires_grad", "is_leaf", "names"}
_STATIC_METHODS = {"stride", "is_contiguous", "numel", "dim", "size",
                   "element_size", "get_device", "is_floating_point",
                   "is_complex", "nelement", "storage_offset", "data_ptr"}
_STATIC_CALLS = {"len", "isinstance", "getattr", "hasattr", "type"}
_GROWERS = {"append", "extend", "insert", "add", "update"}
_BRANCHES = (ast.If, ast.While, ast.Assert, ast.IfExp)
# helpers that read only their arguments' metadata, so a branch on
# their result reads no value: name -> defining module (each entry is
# held to ``host_only`` by the tests)
HOST_HELPERS: Dict[str, str] = {"_time_major": "core/monitor.py"}


@dataclasses.dataclass(frozen=True)
class JitContract:
    module: str                 # path suffix, e.g. "control/policy.py"
    roots: Tuple[str, ...]      # functions whose bodies are traced
    traced: FrozenSet[str]      # parameter names that are traced operands


JIT_CONTRACTS: Tuple[JitContract, ...] = (
    JitContract(
        module="control/policy.py",
        roots=("_capture", "_step_math"),
        traced=frozenset({
            "state", "lam", "mu", "ready", "replicas", "rep_basis",
            "caps", "cv2", "occupancy", "saturated", "scalable",
            "fleet_med", "stale", "faulty", "leg_rep", "leg_buf",
            "leg_adm", "headroom", "max_reps", "occ_hi", "occ_lo",
            "pressure", "slo_target", "over_frac", "current",
        })),
    JitContract(
        module="core/monitor.py",
        roots=("run_monitor_fleet", "_fleet_plan"),
        traced=frozenset({"state", "tc_seq", "blocked_seq"})),
    JitContract(
        module="kernels/monitor/ops.py",
        roots=("_fleet_monitor_scan_impl",),
        traced=frozenset({"state", "tc", "blocked", "tc_seq",
                          "blocked_seq", "carry"})),
)

# entry points that donate an argument when called with ``donate=True``
# (the callee updates its tensors in place): name -> (positional index
# or None, keyword name)
DONATING_CALLS: Dict[str, Tuple[Optional[int], str]] = {
    "control_decide": (1, "state"),
    "fleet_monitor_scan": (1, "state"),
    "_fleet_monitor_scan_impl": (1, "state"),
    "run_monitor_fleet": (None, "state"),
}

# the port's step caches, keyed by some of their arguments (the cached
# decision step by (config, padded Q, device)): name -> key positions.
# ``functools.lru_cache``d functions are keyed by every argument.
CACHE_KEYS: Dict[str, Tuple[int, ...]] = {"_decide_step": (0, 1, 2)}


class RetraceSentinel(Checker):
    name = "RetraceSentinel"

    def check(self, src: Source) -> Iterator[Finding]:
        contracts = [c for c in JIT_CONTRACTS
                     if src.rel.endswith(c.module)]
        for contract in contracts:
            yield from self._check_contract(src, contract)
        yield from self._check_static_args(src)
        yield from self._check_donation(src)

    # -- RS002: traced-value branches --------------------------------------
    def _check_contract(self, src, contract) -> Iterator[Finding]:
        fns = {}
        for node in ast.walk(src.tree):
            if isinstance(node, ast.FunctionDef):
                fns.setdefault(node.name, node)
        region: Set[str] = set()
        queue = [r for r in contract.roots if r in fns]
        while queue:
            name = queue.pop()
            if name in region:
                continue
            region.add(name)
            for call in (n for n in ast.walk(fns[name])
                         if isinstance(n, ast.Call)):
                callee = _local_callee(call.func)
                if callee in fns and callee not in region:
                    queue.append(callee)
        for name in sorted(region):
            yield from self._check_traced_fn(src, fns[name],
                                             contract.traced)

    def _check_traced_fn(self, src, fn, vocab) -> Iterator[Finding]:
        tainted = {a.arg for a in fn.args.args if a.arg in vocab}
        if fn.args.kwarg is not None and fn.args.kwarg.arg == "operands":
            tainted.add("operands")
        if not tainted:
            return
        _propagate(fn, tainted)
        for node in ast.walk(fn):
            if isinstance(node, _BRANCHES) and \
                    _expr_tainted(node.test, tainted):
                kind = type(node).__name__.lower()
                yield self.finding(
                    "RS002", src, node,
                    f"python {kind} conditioned on a tensor's value "
                    f"inside the '{fn.name}' traced region — a "
                    f"device-to-host sync per dispatch (an error under "
                    f"torch.cuda.graph); use torch.where, or hoist to "
                    f"the dispatcher")

    # -- RS001: unhashable statics -----------------------------------------
    def _check_static_args(self, src) -> Iterator[Finding]:
        fns = {n.name: n for n in ast.walk(src.tree)
               if isinstance(n, ast.FunctionDef)}
        jitted: Dict[str, Tuple[int, ...]] = {}
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call) and \
                    _is_jax_jit(node.value.func):
                nums = _static_argnums(node.value)
                if nums and len(node.targets) == 1 and \
                        isinstance(node.targets[0], ast.Name):
                    jitted[node.targets[0].id] = nums
            if isinstance(node, ast.Call) and _is_jax_jit(node.func):
                nums = _static_argnums(node)
                if not nums:
                    continue
                wrapped = node.args[0] if node.args else None
                name = wrapped.id if isinstance(wrapped, ast.Name) \
                    else None
                fn = fns.get(name)
                if fn is None:
                    continue
                params = [a.arg for a in fn.args.args]
                defaults = fn.args.defaults
                off = len(params) - len(defaults)
                for i in nums:
                    if i < off or i >= len(params):
                        continue
                    if _unhashable_literal(defaults[i - off]):
                        yield self.finding(
                            "RS001", src, fn,
                            f"static parameter '{params[i]}' of jitted "
                            f"'{fn.name}' has an unhashable default — "
                            f"every dispatch raises or retraces")
        # the port's caches: an lru_cache keys on every argument, a step
        # cache on the positions CACHE_KEYS names
        keyed: Dict[str, Tuple[int, ...]] = dict(CACHE_KEYS)
        for fn in fns.values():
            if not _lru_cached(fn):
                continue
            keyed[fn.name] = tuple(range(len(fn.args.args)))
            for arg, default in _defaults(fn):
                if _unhashable_literal(default):
                    yield self.finding(
                        "RS001", src, fn,
                        f"parameter '{arg}' of cached '{fn.name}' has an "
                        f"unhashable default — every call raises "
                        f"TypeError")
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node.func)
            if isinstance(node.func, ast.Name) and name in jitted:
                for i in jitted[name]:
                    if i < len(node.args) and \
                            _unhashable_literal(node.args[i]):
                        yield self.finding(
                            "RS001", src, node,
                            f"unhashable value passed at static "
                            f"position {i} of jitted "
                            f"'{name}' — raises TypeError at "
                            f"dispatch")
            elif name in keyed:
                bad = [str(i) for i in keyed[name]
                       if i < len(node.args)
                       and _unhashable_literal(node.args[i])]
                if name in fns and _lru_cached(fns[name]):
                    bad += [k.arg for k in node.keywords
                            if _unhashable_literal(k.value)]
                if bad:
                    yield self.finding(
                        "RS001", src, node,
                        f"unhashable value passed as key argument "
                        f"{', '.join(bad)} of cached '{name}' — raises "
                        f"TypeError at the cache lookup")

    # -- RS003: donated-buffer escape --------------------------------------
    def _check_donation(self, src) -> Iterator[Finding]:
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.FunctionDef):
                continue
            donating: Dict[str, Tuple[int, ...]] = {}
            for n in ast.walk(node):
                if isinstance(n, ast.Assign) and \
                        isinstance(n.value, ast.Call) and \
                        _is_jax_jit(n.value.func) and \
                        len(n.targets) == 1 and \
                        isinstance(n.targets[0], ast.Name):
                    nums = _donate_argnums(n.value)
                    if nums:
                        donating[n.targets[0].id] = nums
            yield from self._scan_block(src, node.body, donating, {})

    def _scan_block(self, src, body, donating, donated
                    ) -> Iterator[Finding]:
        donated = dict(donated)         # expr -> donating-call line
        for stmt in body:
            if any(True for _ in _bodies(stmt)):
                # compound statement: child blocks inherit the current
                # donation set; donations made inside stay inside (the
                # sanctioned idiom rebinds within the call statement),
                # and any rebind inside clears the name conservatively
                for child in _bodies(stmt):
                    yield from self._scan_block(src, child, donating,
                                                donated)
                inner_assigned: Set[str] = set()
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.stmt):
                        inner_assigned |= _assigned_names(sub)
                for expr in list(donated):
                    if expr in inner_assigned:
                        del donated[expr]
                continue
            for expr, line in donated.items():
                if _reads_name(stmt, expr):
                    yield self.finding(
                        "RS003", src, stmt,
                        f"reads '{expr}' after it was donated to the "
                        f"dispatch on line {line} — the callee updates "
                        f"its tensors in place")
            for call in (n for n in ast.walk(stmt)
                         if isinstance(n, ast.Call)):
                name = _call_name(call.func)
                args = []
                if isinstance(call.func, ast.Name) and name in donating:
                    args = [call.args[i] for i in donating[name]
                            if i < len(call.args)]
                elif name in DONATING_CALLS and any(
                        k.arg == "donate" and
                        isinstance(k.value, ast.Constant) and
                        k.value.value is True for k in call.keywords):
                    i, kw = DONATING_CALLS[name]
                    args = ([call.args[i]] if i is not None
                            and i < len(call.args) else
                            [k.value for k in call.keywords
                             if k.arg == kw])
                for arg in args:
                    expr = dotted_name(arg)
                    if expr:
                        donated[expr] = call.lineno
            rebound = _assigned_names(stmt)
            for expr in list(donated):
                if expr in rebound:
                    del donated[expr]


class StylePass(Checker):
    name = "StylePass"

    _SCOPED = (PACKAGE + "/train/", PACKAGE + "/launch/")

    def check(self, src: Source) -> Iterator[Finding]:
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Call) and \
                    dotted_name(node.func) == "time.time":
                note = src.annotation(node.lineno, "wall-clock")
                if note is None:
                    yield self.finding(
                        "ST101", src, node,
                        "time.time() without a '# wall-clock: <reason>' "
                        "annotation — durations must use "
                        "time.monotonic()")
                elif not note:
                    yield self.finding(
                        "ST101", src, node,
                        "'# wall-clock:' annotation gives no reason")
        if any(src.rel.startswith(p) for p in self._SCOPED):
            for node in ast.walk(src.tree):
                if isinstance(node, ast.ExceptHandler) and \
                        _is_broad(node.type):
                    if src.annotation(node.lineno,
                                      "crash-containment") in (None, ""):
                        yield self.finding(
                            "ST102", src, node,
                            "broad except in train/launch — catch the "
                            "concrete failure types (and log context), "
                            "or annotate '# crash-containment: "
                            "<reason>'")


def _is_broad(type_node) -> bool:
    if type_node is None:
        return True
    names = [type_node] if not isinstance(type_node, ast.Tuple) \
        else list(type_node.elts)
    return any(isinstance(n, ast.Name) and
               n.id in ("Exception", "BaseException") for n in names)


def _is_jax_jit(func) -> bool:
    return dotted_name(func) in ("jax.jit", "jit")


def _lru_cached(fn) -> bool:
    """``@functools.lru_cache``/``@functools.cache`` (with or without a
    call, with or without the module prefix)."""
    for dec in fn.decorator_list:
        name = dotted_name(dec.func if isinstance(dec, ast.Call) else dec)
        if name in ("functools.lru_cache", "lru_cache", "functools.cache",
                    "cache"):
            return True
    return False


def _defaults(fn):
    """(parameter, default) for every parameter that has one."""
    args = fn.args
    pos = args.posonlyargs + args.args
    out = list(zip([a.arg for a in pos[len(pos) - len(args.defaults):]],
                   args.defaults))
    out += [(a.arg, d) for a, d in zip(args.kwonlyargs, args.kw_defaults)
            if d is not None]
    return out


def _call_name(func) -> Optional[str]:
    """'f' for ``f(...)`` and ``mod.f(...)``/``self.f(...)``."""
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _local_callee(func) -> Optional[str]:
    """The module-local function a call reaches: ``f(...)`` or a method
    through ``self.f(...)``."""
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute) and \
            isinstance(func.value, ast.Name) and func.value.id == "self":
        return func.attr
    return None


def _expr_tainted(expr, tainted) -> bool:
    """True when ``expr`` reads a tainted tensor's value.  Metadata is
    host-side and reads nothing (``x.shape``, ``x.device.type``,
    ``x.stride(0)``, ``x.is_contiguous()``, ``len(x)``, ``x is None``,
    a helper in ``HOST_HELPERS``); a method of a tainted tensor
    (``t.any()``, ``t.item()``, ``t.tolist()``) or a builtin over it
    (``float(t)``, ``int(t)``) reads its value."""
    if isinstance(expr, ast.Name):
        return expr.id in tainted
    if isinstance(expr, ast.Attribute):
        if expr.attr in _STATIC_ATTRS:
            return False
        return _expr_tainted(expr.value, tainted)
    if isinstance(expr, ast.Compare) and len(expr.ops) == 1 and \
            isinstance(expr.ops[0], (ast.Is, ast.IsNot)):
        return False                     # presence check
    if isinstance(expr, ast.Call):
        func = expr.func
        if isinstance(func, ast.Name) and \
                (func.id in _STATIC_CALLS or func.id in HOST_HELPERS):
            return False
        if isinstance(func, ast.Attribute):
            if func.attr in _STATIC_METHODS:
                return False
            if _expr_tainted(func.value, tainted):
                return True
        return any(_expr_tainted(a, tainted)
                   for a in list(expr.args)
                   + [k.value for k in expr.keywords])
    if isinstance(expr, ast.Subscript):
        return _expr_tainted(expr.value, tainted) or \
            _expr_tainted(expr.slice, tainted)
    if isinstance(expr, (ast.GeneratorExp, ast.ListComp, ast.SetComp,
                         ast.DictComp)):
        inner = set(tainted)
        for gen in expr.generators:
            if _expr_tainted(gen.iter, inner):
                inner |= {n.id for n in ast.walk(gen.target)
                          if isinstance(n, ast.Name)}
        elts = ([expr.key, expr.value] if isinstance(expr, ast.DictComp)
                else [expr.elt])
        return any(_expr_tainted(e, inner)
                   for e in elts + [c for g in expr.generators
                                    for c in g.ifs])
    for child in ast.iter_child_nodes(expr):
        if isinstance(child, ast.expr) and \
                _expr_tainted(child, tainted):
            return True
    return False


def _propagate(fn, tainted: Set[str]) -> None:
    """Grow ``tainted`` through ``fn``'s assignments until stable; a
    tuple assigned from a tuple of the same length taints pairwise, and
    a container that a tainted value is appended to is tainted."""
    for _ in range(3):
        grew = False
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _GROWERS and \
                    isinstance(node.func.value, ast.Name) and \
                    node.func.value.id not in tainted and \
                    any(_expr_tainted(a, tainted)
                        for a in node.args):
                tainted.add(node.func.value.id)
                grew = True
            if not isinstance(node, ast.Assign):
                continue
            for t in node.targets:
                pairs = [(t, node.value)]
                if isinstance(t, ast.Tuple) and \
                        isinstance(node.value, ast.Tuple) and \
                        len(t.elts) == len(node.value.elts):
                    pairs = list(zip(t.elts, node.value.elts))
                for target, value in pairs:
                    if not _expr_tainted(value, tainted):
                        continue
                    for n in ast.walk(target):
                        if isinstance(n, ast.Name) and n.id not in tainted:
                            tainted.add(n.id)
                            grew = True
        if not grew:
            break


def host_only(fn) -> bool:
    """True for a function whose result reads only its arguments'
    metadata: with every parameter tainted, no ``return`` expression and
    no branch reads a value (``_time_major``: ``not x.is_contiguous() and
    x.T.is_contiguous()``)."""
    a = fn.args
    tainted = {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs}
    returns = [n.value for n in ast.walk(fn)
               if isinstance(n, ast.Return) and n.value is not None]
    tests = [n.test for n in ast.walk(fn) if isinstance(n, _BRANCHES)]
    if not tainted or not returns:
        return False
    _propagate(fn, tainted)
    return not any(_expr_tainted(e, tainted) for e in returns + tests)


def _keyword(call, name):
    for k in call.keywords:
        if k.arg == name:
            return k.value
    return None


def _tuple_ints(node) -> Tuple[int, ...]:
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return (node.value,)
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for e in node.elts:
            if isinstance(e, ast.Constant) and isinstance(e.value, int):
                out.append(e.value)
        return tuple(out)
    return ()


def _static_argnums(call) -> Tuple[int, ...]:
    node = _keyword(call, "static_argnums")
    return _tuple_ints(node) if node is not None else ()


def _donate_argnums(call) -> Tuple[int, ...]:
    node = _keyword(call, "donate_argnums")
    return _tuple_ints(node) if node is not None else ()


def _unhashable_literal(node) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                         ast.DictComp, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        return dotted_name(node.func) in ("np.array", "numpy.array",
                                          "jnp.array", "np.zeros",
                                          "np.ones", "jnp.zeros",
                                          "jnp.ones", "bytearray")
    return False


def _assigned_names(stmt) -> Set[str]:
    out: Set[str] = set()
    targets = []
    if isinstance(stmt, ast.Assign):
        targets = stmt.targets
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        targets = [stmt.target]
    elif isinstance(stmt, ast.For):
        targets = [stmt.target]
    for t in targets:
        for n in ast.walk(t):
            name = dotted_name(n)
            if name:
                out.add(name)
    return out


def _reads_name(stmt, expr: str) -> bool:
    for n in ast.walk(stmt):
        if dotted_name(n) == expr and \
                isinstance(getattr(n, "ctx", None), ast.Load):
            return True
    return False


def _bodies(stmt):
    for attr in ("body", "orelse", "finalbody"):
        b = getattr(stmt, attr, None)
        if b and isinstance(b, list) and \
                all(isinstance(s, ast.stmt) for s in b):
            yield b
    for handler in getattr(stmt, "handlers", []) or []:
        yield handler.body
