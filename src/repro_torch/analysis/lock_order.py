"""Canonical lock hierarchy for the port's whole control plane, plus
the AST checker that walks every ``with <lock>:`` nesting in
``src/repro_torch/`` against it.

``LOCK_ORDER`` is THE declaration — the prose audits in
``control/loop.py``, ``control/group.py``, ``streams/fleet.py`` and
``serve/engine.py`` reference it instead of restating the hierarchy.
It keeps the JAX package's six levels and places the port's own locks
in them (marked *port* below).  Rank strictly decreases
outermost-to-innermost:

====  =========  =====================================================
rank  level      locks
====  =========  =====================================================
0     group      ``ControlGroup._lock`` (tenant attach/detach/policy)
1     loop       ``ControlLoop._lock`` (tick, remap, policy swap)
2     service    ``FleetMonitorService._lock`` (window matrices, slots)
3     arena      ``CounterArena.lock`` (slot alloc, grow, defrag)
4     sync       protocol-disjoint leaves: ``InstrumentedQueue
                 ._resize_lock``, ``Stage._stop_lock``, pipeline/engine
                 ``_scale_lock``/``_crash_lock``/``_sink_lock``/
                 ``_acct_lock``, the admission-gate condition, the QoS
                 registry and default-arena singleton locks; *port*:
                 ``control.policy._STEPS_LOCK`` (the cache of decision
                 steps: taken from the loop's tick under the loop lock,
                 it builds a step and captures its CUDA graph inside and
                 takes nothing else), ``_DecideStep.lock`` (one captured
                 decision graph: load, replay, read back), and
                 ``NvccLibrary._lock`` in ``kernels/_build.py`` (the
                 nvcc build at a kernel's first launch, which can come
                 inside a monitor dispatch holding the service lock, so
                 it ranks below it; it runs nvcc and loads the library,
                 taking no lock)
5     audit      observation-only leaves that may be taken under any
                 of the above and take nothing themselves:
                 ``ControlLog._lock``, exporter/counter locks,
                 ``FaultInjector._lock``, checkpoint-manager lock;
                 *port*: the launch counters' ``_COUNT_LOCK`` in
                 ``kernels/attention/kernel.py`` and
                 ``kernels/ssd/kernel.py`` (one increment a launch)
====  =========  =====================================================

A thread may acquire a lock only while holding locks of *strictly
lower* rank number?  No — the reverse: holding rank ``r``, it may only
acquire rank ``> r`` (downward in the table).  Ranks 4 and 5 are
*unordered tiers*: their members are mutually disjoint by protocol, so
same-rank nesting is legal and cross-thread ABBA hazards among them
are caught by the :class:`~repro_torch.analysis.witness.LockWitness`
cycle detector instead of a static total order.

Functions named ``*_locked`` are, by repo-wide convention, called with
their module's primary lock already held (overrides in
``LOCKED_FN_LEVELS`` for the exceptions, e.g. fleet's
``_rebind_slots_locked`` runs under the *arena* lock).
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Iterator, Optional, Tuple

from .model import Checker, Finding, Source, dotted_name


@dataclasses.dataclass(frozen=True)
class LockLevel:
    rank: int
    name: str
    doc: str
    # AST patterns: (module suffix or None, dotted-expr suffix).  An
    # expr pattern starting with "." matches any dotted tail; otherwise
    # it must equal the whole expression.
    exprs: Tuple[Tuple[Optional[str], str], ...]
    # runtime-witness creation sites: (module suffix, assigned attr)
    sites: Tuple[Tuple[str, str], ...]
    ordered: bool = True   # False: same-rank nesting allowed (disjoint tier)


LOCK_ORDER: Tuple[LockLevel, ...] = (
    LockLevel(
        0, "group", "ControlGroup._lock — tenant membership and policy "
        "overrides; outermost so attach/detach can quiesce the loop",
        exprs=(("control/group.py", "self._lock"), (None, "._group._lock"),
               (None, "group._lock")),
        sites=(("control/group.py", "_lock"),)),
    LockLevel(
        1, "loop", "ControlLoop._lock — tick/remap/policy-swap critical "
        "section",
        exprs=(("control/loop.py", "self._lock"), (None, ".loop._lock"),
               (None, "._loop._lock"), (None, "loop._lock")),
        sites=(("control/loop.py", "_lock"),)),
    LockLevel(
        2, "service", "FleetMonitorService._lock — window matrices, slot "
        "mirrors, SLO caches",
        exprs=(("streams/fleet.py", "self._lock"), (None, ".service._lock"),
               (None, "._service._lock"), (None, ".svc._lock"),
               (None, ".fleet._lock")),
        sites=(("streams/fleet.py", "_lock"),)),
    LockLevel(
        3, "arena", "CounterArena.lock — slot alloc/retire, growth, "
        "defragmentation",
        exprs=(("streams/arena.py", "self.lock"), (None, "arena.lock"),
               (None, ".arena.lock"), (None, "._arena.lock")),
        sites=(("streams/arena.py", "lock"),)),
    LockLevel(
        4, "sync", "protocol-disjoint structural leaves (queue resize, "
        "stage stop, scale/accounting/crash/sink, admission gate, "
        "registries; the port's decision-step cache, one decision graph "
        "and the kernel build)",
        exprs=((None, "._resize_lock"), (None, "._stop_lock"),
               (None, "._scale_lock"), (None, "._acct_lock"),
               (None, "._crash_lock"), (None, "._sink_lock"),
               (None, "._cond"), ("serve/qos.py", "_LOCK"),
               ("streams/arena.py", "_DEFAULT_LOCK"),
               ("control/policy.py", "_STEPS_LOCK"),
               ("control/policy.py", "step.lock"),
               ("kernels/_build.py", "self._lock")),
        sites=(("streams/queue.py", "_resize_lock"),
               ("streams/pipeline.py", "_stop_lock"),
               ("streams/pipeline.py", "_scale_lock"),
               ("streams/pipeline.py", "_crash_lock"),
               ("streams/pipeline.py", "_sink_lock"),
               ("serve/engine.py", "_scale_lock"),
               ("serve/engine.py", "_acct_lock"),
               ("serve/engine.py", "_crash_lock"),
               ("serve/engine.py", "_cond"),
               ("serve/qos.py", "_LOCK"),
               ("streams/arena.py", "_DEFAULT_LOCK"),
               ("control/policy.py", "_STEPS_LOCK"),
               ("control/policy.py", "lock"),
               ("kernels/_build.py", "_lock")),
        ordered=False),
    LockLevel(
        5, "audit", "observation-only leaves: control log ring, metrics "
        "exporter, fault injector, checkpoint manager, kernel launch "
        "counters",
        exprs=(("control/log.py", "self._lock"),
               ("obs/exporter.py", "self._lock"),
               ("ft/inject.py", "self._lock"),
               ("ckpt/manager.py", "self._lock"),
               (None, ".log._lock"), (None, "._log._lock"),
               ("kernels/attention/kernel.py", "_COUNT_LOCK"),
               ("kernels/ssd/kernel.py", "_COUNT_LOCK")),
        sites=(("control/log.py", "_lock"),
               ("obs/exporter.py", "_lock"),
               ("ft/inject.py", "_lock"),
               ("ckpt/manager.py", "_lock"),
               ("kernels/attention/kernel.py", "_COUNT_LOCK"),
               ("kernels/ssd/kernel.py", "_COUNT_LOCK")),
        ordered=False),
)

RANK = {lv.name: lv.rank for lv in LOCK_ORDER}

# ``*_locked`` functions run with their module's primary level already
# held; exceptions are declared here (module suffix, function name).
MODULE_PRIMARY_LEVEL = {
    "control/group.py": "group",
    "control/loop.py": "loop",
    "streams/fleet.py": "service",
    "streams/arena.py": "arena",
    "serve/engine.py": "sync",
    "streams/pipeline.py": "sync",
}
LOCKED_FN_LEVELS = {
    # rebinds EndStats views after growth/defrag: runs under arena.lock
    ("streams/fleet.py", "_rebind_slots_locked"): "arena",
}


def classify_expr(rel: str, expr: str) -> Optional[LockLevel]:
    """Level of a ``with <expr>:`` acquisition in module ``rel``."""
    for lv in LOCK_ORDER:
        for mod, pat in lv.exprs:
            if mod is not None and not rel.endswith(mod):
                continue
            if pat.startswith("."):
                if expr.endswith(pat):
                    return lv
            elif expr == pat or expr.endswith("." + pat):
                return lv
    return None


def classify_site(rel: str, attr: str) -> Optional[LockLevel]:
    """Level of a lock created as ``<attr> = threading.Lock()`` (or
    Condition/RLock) in module ``rel`` — the witness's classifier."""
    for lv in LOCK_ORDER:
        for mod, name in lv.sites:
            if rel.endswith(mod) and attr == name:
                return lv
    return None


def held_level_of(rel: str, fn_name: str) -> Optional[LockLevel]:
    """Level assumed held on entry to a ``*_locked`` function."""
    if not fn_name.endswith("_locked"):
        return None
    for (mod, name), level in LOCKED_FN_LEVELS.items():
        if rel.endswith(mod) and fn_name == name:
            return LOCK_ORDER[RANK[level]]
    for mod, level in MODULE_PRIMARY_LEVEL.items():
        if rel.endswith(mod):
            return LOCK_ORDER[RANK[level]]
    return None


def _looks_like_lock(expr: str) -> bool:
    tail = expr.rsplit(".", 1)[-1].lower()
    return "lock" in tail or tail == "_cond"


class LockOrderChecker(Checker):
    """Walk every lexical ``with`` nesting against ``LOCK_ORDER``.

    LO001  rank inversion (acquiring an outer-ranked lock while a
           deeper-ranked one is held)
    LO002  lock-looking acquisition not classified by LOCK_ORDER — the
           table must stay exhaustive, so new locks are declared here
           the day they are introduced
    LO003  lexical re-acquisition of the same (ordered) level — a
           self-deadlock with non-reentrant locks
    """

    name = "LockOrderChecker"

    def check(self, src: Source) -> Iterator[Finding]:
        for node in ast.walk(src.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                entry = held_level_of(src.rel, node.name)
                held = [(entry, f"<{node.name} entry>", node.lineno)] \
                    if entry else []
                yield from self._walk(src, node.body, held, node)
            elif isinstance(node, ast.Module):
                yield from self._walk(src, node.body, [], None)

    def _walk(self, src, body, held, owner) -> Iterator[Finding]:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue   # separate execution context (ast.walk visits it)
            if isinstance(stmt, ast.With):
                pushed = 0
                for item in stmt.items:
                    expr = dotted_name(item.context_expr)
                    if expr is None and isinstance(item.context_expr,
                                                   ast.Call):
                        expr = dotted_name(item.context_expr.func)
                    if expr is None or not _looks_like_lock(expr):
                        continue
                    level = classify_expr(src.rel, expr)
                    if level is None:
                        yield self.finding(
                            "LO002", src, stmt,
                            f"acquisition of '{expr}' is not classified "
                            f"by repro_torch.analysis.lock_order."
                            f"LOCK_ORDER — declare its level")
                        continue
                    for h_level, h_expr, h_line in held:
                        if h_level.rank > level.rank:
                            yield self.finding(
                                "LO001", src, stmt,
                                f"acquires {level.name}-rank lock "
                                f"'{expr}' while holding {h_level.name}"
                                f"-rank '{h_expr}' (line {h_line}) — "
                                f"inverts LOCK_ORDER "
                                f"({h_level.rank} > {level.rank})")
                        elif (h_level.rank == level.rank
                              and level.ordered):
                            yield self.finding(
                                "LO003", src, stmt,
                                f"re-enters {level.name}-rank lock "
                                f"'{expr}' while '{h_expr}' (line "
                                f"{h_line}) is held — self-deadlock "
                                f"with non-reentrant locks")
                    held.append((level, expr, stmt.lineno))
                    pushed += 1
                yield from self._walk(src, stmt.body, held, owner)
                del held[len(held) - pushed:]
            else:
                for child_body in _nested_bodies(stmt):
                    yield from self._walk(src, child_body, held, owner)


def _nested_bodies(stmt):
    for attr in ("body", "orelse", "finalbody"):
        body = getattr(stmt, attr, None)
        if body and isinstance(body, list) \
                and all(isinstance(s, ast.stmt) for s in body):
            yield body
    for handler in getattr(stmt, "handlers", []) or []:
        yield handler.body
