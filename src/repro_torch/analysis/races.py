"""BenignRaceChecker: every unlocked mutation of an arena column array
must carry a ``# benign-race: <contract>`` annotation naming which
documented contract makes the race benign.

The arena's hot paths (producers bumping ``tc``/``bytes_count``,
consumers flipping ``blocked``, latency recording, the monitor's
copy-and-zero) write the shared column arrays without taking
``CounterArena.lock`` — that is the paper's design (§III: non-blocking
instrumentation), and it is safe only because each site obeys one of a
small set of named contracts (see ``analysis/README.md``):

* ``copy-and-zero``  — a torn read/zero pair costs at most one
  monitoring period's counts (the paper's benign single-period race);
* ``growth-rebind``  — ``_bind`` writes slot-then-arrays while hot
  paths read array-then-slot, so a racing rebind drops the increment
  into the abandoned array, never another live slot;
* ``cumulative-window`` — monotone counters harvested by delta, where
  a late increment shifts one window, never corrupts.

A mutation is exempt when it is lexically inside a ``with`` on the
arena lock, or inside a ``*_locked`` function (the caller-holds-lock
convention).  Everything else needs the annotation — so every
lock-free write is greppable and names its justification.

BR001  unlocked column mutation without a ``# benign-race:`` annotation
BR002  annotation present but empty (names no contract)
"""
from __future__ import annotations

import ast
from typing import Iterator, Optional, Set

from .lock_order import classify_expr, held_level_of
from .model import PACKAGE, Checker, Finding, Source, dotted_name

# arena column attributes and their EndStats view aliases
COLUMN_ATTRS: Set[str] = {
    "tc", "blocked", "bytes_count", "err_count", "lat_hist", "lat_count",
    "_tc", "_blk", "_byt", "_err", "_hist", "_cnt",
}


class BenignRaceChecker(Checker):
    name = "BenignRaceChecker"

    def check(self, src: Source) -> Iterator[Finding]:
        if not src.rel.startswith(PACKAGE + "/"):
            return
        for node in ast.walk(src.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._check_fn(src, node)

    def _check_fn(self, src, fn) -> Iterator[Finding]:
        locked_entry = held_level_of(src.rel, fn.name)
        entry_is_arena = locked_entry is not None and \
            locked_entry.name == "arena"
        # names aliasing a column array: ``tc_arr = end._tc``
        aliases: Set[str] = set()
        for stmt in ast.walk(fn):
            if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1:
                continue
            target, value = stmt.targets[0], stmt.value
            pairs = [(target, value)]
            if isinstance(target, ast.Tuple) and \
                    isinstance(value, ast.Tuple) and \
                    len(target.elts) == len(value.elts):
                pairs = list(zip(target.elts, value.elts))
            for t, v in pairs:
                if isinstance(t, ast.Name) and \
                        self._is_column_ref(v, aliases):
                    aliases.add(t.id)
        yield from self._walk(src, fn.body, entry_is_arena, aliases)

    def _walk(self, src, body, under_arena_lock, aliases
              ) -> Iterator[Finding]:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(stmt, ast.With):
                inside = under_arena_lock
                for item in stmt.items:
                    expr = dotted_name(item.context_expr)
                    if expr:
                        lv = classify_expr(src.rel, expr)
                        if lv is not None and lv.name == "arena":
                            inside = True
                yield from self._walk(src, stmt.body, inside, aliases)
                continue
            target = None
            if isinstance(stmt, ast.Assign):
                for t in stmt.targets:
                    if self._mutates_column(t, aliases):
                        target = t
            elif isinstance(stmt, ast.AugAssign):
                if self._mutates_column(stmt.target, aliases):
                    target = stmt.target
            if target is not None and not under_arena_lock:
                note = src.annotation(stmt.lineno, "benign-race")
                if note is None:
                    yield self.finding(
                        "BR001", src, stmt,
                        f"unlocked mutation of arena column "
                        f"'{dotted_name(target.value) or '?'}' needs a "
                        f"'# benign-race: <contract>' annotation")
                elif not note:
                    yield self.finding(
                        "BR002", src, stmt,
                        "'# benign-race:' annotation names no contract")
            for child in _stmt_bodies(stmt):
                yield from self._walk(src, child, under_arena_lock,
                                      aliases)

    def _mutates_column(self, target, aliases) -> bool:
        return isinstance(target, ast.Subscript) and \
            self._is_column_ref(target.value, aliases)

    @staticmethod
    def _is_column_ref(node, aliases) -> bool:
        if isinstance(node, ast.Attribute) and node.attr in COLUMN_ATTRS:
            return True
        if isinstance(node, ast.Name) and node.id in aliases:
            return True
        return False


def _stmt_bodies(stmt):
    for attr in ("body", "orelse", "finalbody"):
        body = getattr(stmt, attr, None)
        if body and isinstance(body, list) \
                and all(isinstance(s, ast.stmt) for s in body):
            yield body
    for handler in getattr(stmt, "handlers", []) or []:
        yield handler.body
