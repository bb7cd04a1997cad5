"""Contract analyzer for the port's streaming control plane.

Four AST checkers plus one runtime witness enforce the invariants the
rest of the port states in prose: the canonical lock hierarchy
(:data:`~repro_torch.analysis.lock_order.LOCK_ORDER`), the dispatch
contracts (one build per configuration, no value read of a tensor in a
traced region, no donated-buffer reuse), the import DAG, and the
annotated-benign-race rule for the arena's lock-free columns.
``python -m repro_torch.analysis src/repro_torch`` runs everything and
exits nonzero on any finding not in the explicit baseline; the same
pass runs as a tier-1 test and as a phase of ``chip_smoke.py``.  See
``README.md`` in this package for the checker catalog.

Stdlib-only by design: the analyzer must run on a box where the
numeric stack is broken, because its job is to catch what breaks it.
It is the twin of the JAX package's ``repro.analysis`` and imports
nothing from it.
"""
from __future__ import annotations

from typing import Iterable, List, Optional

from .layering import LayerGuard
from .lock_order import LOCK_ORDER, LockOrderChecker
from .model import Baseline, Checker, Finding, Source, iter_sources
from .races import BenignRaceChecker
from .retrace import RetraceSentinel, StylePass
from .witness import LockHazard, LockWitness, WitnessedLock, armed

ALL_CHECKERS = (LockOrderChecker, LayerGuard, BenignRaceChecker,
                RetraceSentinel, StylePass)


def run_analysis(paths: Iterable[str],
                 checkers: Optional[Iterable[Checker]] = None
                 ) -> List[Finding]:
    """Run every checker over all ``.py`` files under ``paths``."""
    active = list(checkers) if checkers is not None \
        else [cls() for cls in ALL_CHECKERS]
    findings: List[Finding] = []
    for src in iter_sources(paths):
        for checker in active:
            findings.extend(checker.check(src))
    findings.sort(key=lambda f: (f.path, f.line, f.code))
    return findings


__all__ = [
    "ALL_CHECKERS", "Baseline", "BenignRaceChecker", "Checker",
    "Finding", "LayerGuard", "LOCK_ORDER", "LockOrderChecker",
    "LockWitness", "RetraceSentinel", "Source", "StylePass",
    "WitnessedLock", "iter_sources", "run_analysis", "LockHazard",
    "armed",
]
