"""Runtime lock witness: instrumented ``threading.Lock``/``RLock``
wrappers that check every real acquisition against the canonical
``LOCK_ORDER`` while the concurrency suites run.

Activation monkeypatches the ``threading`` lock factories, and wraps
the classified module-level locks of the package's modules already
imported (deactivation puts both back).  Each new lock is classified by
its *creation site*: the first stack frame outside ``threading``/this
module decides which source line allocated it, and
:func:`~repro_torch.analysis.lock_order.classify_site` maps ``(module,
assigned attribute)`` to a hierarchy level.  Locks created
from unclassified sites (pytest internals, torch, thread bookkeeping)
get the raw uninstrumented primitive back — zero overhead off the
contract surface, and zero cost everywhere once ``deactivate()``
restores the factories.

Two hazard classes are recorded:

* **inversions** — a thread acquires a lock whose rank is outer
  (numerically lower) than something it already holds, or re-enters an
  ordered level; the AST checker sees only lexical nesting, this sees
  call-graph nesting (e.g. a queue close releasing an arena slot while
  a scale lock is held).
* **cycles** — directed held->acquired edges between same-rank locks in
  the unordered tiers; an ABBA pattern shows up as a cycle in that
  graph even when each thread's own order looks locally consistent.

Witnesses nest: a test may activate its own instance while a suite's
fixture has one active (activation saves and restores the previous
factories LIFO).  :func:`armed` is the one helper the port's
concurrency suites build their autouse fixture on, and
``chip_smoke.py`` arms one over the card's control plane.
"""
from __future__ import annotations

import contextlib
import linecache
import re
import sys
import threading
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from .lock_order import LockLevel, classify_site
from .model import PACKAGE, package_rel

_ASSIGN_RE = re.compile(r"^\s*(?:[A-Za-z_]\w*\.)*([A-Za-z_]\w*)\s*=")
_SKIP_FILES = ("threading.py", "witness.py", "weakref.py")


def _creation_site() -> Optional[Tuple[str, int]]:
    """(filename, lineno) of the first frame outside threading/witness
    internals, or None when the walk runs out."""
    f = sys._getframe(2)
    for _ in range(20):
        if f is None:
            return None
        fn = f.f_code.co_filename
        if not fn.endswith(_SKIP_FILES):
            return fn, f.f_lineno
        f = f.f_back
    return None


class _Held:
    __slots__ = ("lock", "count")

    def __init__(self, lock):
        self.lock = lock
        self.count = 1


class WitnessedLock:
    """Wrapper delegating to a real Lock/RLock with hierarchy checks.

    Unknown attributes (``_release_save``/``_acquire_restore``/
    ``_is_owned``) fall through to the inner lock so
    ``threading.Condition`` keeps its RLock fast paths; ``hasattr``
    probes therefore see exactly the inner lock's capabilities.
    """

    __slots__ = ("_inner", "_witness", "level", "desc")

    def __init__(self, inner, witness: "LockWitness",
                 level: LockLevel, desc: str):
        self._inner = inner
        self._witness = witness
        self.level = level
        self.desc = desc

    def acquire(self, blocking=True, timeout=-1):
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._witness._on_acquire(self)
        return ok

    def release(self):
        self._witness._on_release(self)
        self._inner.release()

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __repr__(self):
        return f"<WitnessedLock {self.desc} level={self.level.name}>"


class LockWitness:
    """Per-test (or per-block) recorder of lock-hierarchy hazards."""

    def __init__(self):
        self.violations: List[str] = []
        self._edges: Dict[Tuple[int, int], Tuple[str, str]] = {}
        self._locks: List[WitnessedLock] = []   # strong refs: stable ids
        self._tls = threading.local()
        self._saved = None
        self._adopted: List[Tuple[object, str, object]] = []

    # -- instrumentation lifecycle ----------------------------------------
    def activate(self) -> "LockWitness":
        if self._saved is not None:
            raise RuntimeError("LockWitness already active")
        self._saved = (threading.Lock, threading.RLock)
        real_lock, real_rlock = self._saved
        threading.Lock = self._factory(real_lock)       # type: ignore
        threading.RLock = self._factory(real_rlock)     # type: ignore
        self._adopt((type(real_lock()), type(real_rlock())))
        return self

    def deactivate(self) -> None:
        if self._saved is None:
            return
        threading.Lock, threading.RLock = self._saved   # type: ignore
        self._saved = None
        for mod, attr, raw in reversed(self._adopted):
            if getattr(mod, attr, None) in self._locks:
                setattr(mod, attr, raw)
        self._adopted = []

    def _adopt(self, lock_types) -> None:
        """Wrap the classified module-level locks of the package's
        modules imported so far (``control.policy._STEPS_LOCK``, the
        launch counters' ``_COUNT_LOCK``, ...): they exist from import
        time, before any witness.  The wrapper shares the raw lock, so a
        caller that kept the raw object still excludes the others;
        ``deactivate`` puts the raw lock back."""
        for name, mod in list(sys.modules.items()):
            path = getattr(mod, "__file__", None)
            if not name.startswith(PACKAGE + ".") or not path:
                continue
            rel = package_rel(path)
            for attr, raw in list(vars(mod).items()):
                level = (classify_site(rel, attr)
                         if isinstance(raw, lock_types) else None)
                if level is None:
                    continue
                lock = WitnessedLock(raw, self, level, f"{rel}:{attr}")
                self._locks.append(lock)
                self._adopted.append((mod, attr, raw))
                setattr(mod, attr, lock)

    def __enter__(self):
        return self.activate()

    def __exit__(self, *exc):
        self.deactivate()
        return False

    def _factory(self, real):
        def make():
            inner = real()
            site = _creation_site()
            if site is None:
                return inner
            fn, lineno = site
            rel = package_rel(fn)
            if not rel.startswith(PACKAGE + "/"):
                return inner
            m = _ASSIGN_RE.match(linecache.getline(fn, lineno))
            if m is None:
                return inner
            level = classify_site(rel, m.group(1))
            if level is None:
                return inner
            lock = WitnessedLock(inner, self, level,
                                 f"{rel}:{lineno}:{m.group(1)}")
            self._locks.append(lock)
            return lock
        return make

    # -- acquisition bookkeeping ------------------------------------------
    def _held(self) -> List[_Held]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def _on_acquire(self, lock: WitnessedLock) -> None:
        held = self._held()
        for h in held:
            if h.lock is lock:         # reentrant re-acquire (RLock)
                h.count += 1
                return
        for h in held:
            hl = h.lock.level
            if hl.rank > lock.level.rank:
                self.violations.append(
                    f"inversion: acquired {lock.level.name}-rank "
                    f"{lock.desc} while holding {hl.name}-rank "
                    f"{h.lock.desc} ({hl.rank} > {lock.level.rank})")
            elif hl.rank == lock.level.rank and lock.level.ordered:
                self.violations.append(
                    f"same-rank nesting in ordered tier "
                    f"'{lock.level.name}': {h.lock.desc} -> {lock.desc}")
            if hl.rank == lock.level.rank and not lock.level.ordered:
                self._edges[(id(h.lock), id(lock))] = (h.lock.desc,
                                                       lock.desc)
        held.append(_Held(lock))

    def _on_release(self, lock: WitnessedLock) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i].lock is lock:
                held[i].count -= 1
                if held[i].count == 0:
                    del held[i]
                return
        # released on a thread that never acquired it (handoff
        # patterns); nothing to unwind locally

    # -- reporting ---------------------------------------------------------
    def cycles(self) -> List[str]:
        """Cycles in the same-rank held->acquired graph (ABBA hazards
        inside the unordered tiers)."""
        graph: Dict[int, List[int]] = {}
        for (a, b) in self._edges:
            graph.setdefault(a, []).append(b)
        out, state = [], {}

        def visit(n, path):
            state[n] = 1
            for m in graph.get(n, ()):
                if state.get(m) == 1:
                    cyc = path[path.index(m):] + [m] if m in path else [n, m]
                    names = [self._edges.get((cyc[i], cyc[i + 1]),
                                             ("?", "?"))[0]
                             for i in range(len(cyc) - 1)]
                    out.append("cycle: " + " -> ".join(names + [names[0]]))
                elif state.get(m) is None:
                    visit(m, path + [m])
            state[n] = 2

        for n in list(graph):
            if state.get(n) is None:
                visit(n, [n])
        return out

    def report(self) -> List[str]:
        return list(self.violations) + self.cycles()

    def locks(self) -> List[WitnessedLock]:
        """Every lock this witness wrapped, in creation order."""
        return list(self._locks)

    def wrapped(self) -> Dict[int, int]:
        """How many locks this witness wrapped, by rank (ranks with
        none are absent)."""
        out: Dict[int, int] = {}
        for lock in self._locks:
            out[lock.level.rank] = out.get(lock.level.rank, 0) + 1
        return out


class LockHazard(AssertionError):
    """A witness recorded a lock-hierarchy hazard."""


def _raise(message: str) -> None:
    raise LockHazard(message)


@contextlib.contextmanager
def armed(fail: Callable[[str], object] = _raise
          ) -> Iterator[LockWitness]:
    """Run a block under a fresh active :class:`LockWitness`; on a clean
    exit, deactivate it and pass its report to ``fail`` if it recorded
    any hazard (by default raise :class:`LockHazard`).  A block that
    raises keeps its own error.  The port's concurrency suites run each
    module under it (``fail=pytest.fail``)."""
    witness = LockWitness().activate()
    try:
        yield witness
    finally:
        witness.deactivate()
    problems = witness.report()
    if problems:
        fail("LockWitness recorded lock-hierarchy hazards (see "
             "repro_torch.analysis.lock_order.LOCK_ORDER):\n  "
             + "\n  ".join(problems))
