"""QoS classes: the serve path's traffic taxonomy.

The paper's motivating scenario (§I) is a shared machine whose load is
*mixed*: latency-sensitive callers that block on their result, and
patient bulk callers that do not.  A single request lane gives the two
identical treatment, so one bulk burst causes head-of-line collapse for
the blocking callers — the classic failure the bulkhead pattern exists
to prevent.  This module is the extensible registry of traffic classes
the ``serve.Engine`` partitions by:

* every class gets its own submit lane (an ``InstrumentedQueue`` with
  its own contiguous ``CounterArena`` slot pair), so the fleet monitor
  estimates per-class non-blocking λ/μ at zero extra collector cost;
* every class gets its own ``AdmissionGate`` whose mode (shed vs.
  defer) and occupancy band (the fused decision's per-queue
  ``occ_hi``/``occ_lo`` operands) come from the class definition;
* ``patient`` classes are the bulkhead *donors*: their replicas may
  serve a non-patient (blocking) lane when it runs hot — bounded, and
  never the reverse — and their admission arms first under group
  pressure (the decision's ``pressure`` operand).

Two classes are built in — ``"blocking"`` (latency-sensitive, inherits
the engine's ``AdmissionPolicy`` mode, policy-default occupancy band)
and ``"nonblocking"`` (patient, sheds — a patient caller would rather
retry than queue — and arms shedding at a lower occupancy so patient
traffic is shed first).  Register more with ``register_qos_class``;
class churn never retraces the fused decision, because class-specific
behavior rides queue-padded operands, not config shapes.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

__all__ = ["QoSClass", "register_qos_class", "qos_class", "qos_classes",
           "BLOCKING", "NONBLOCKING"]

BLOCKING = "blocking"
NONBLOCKING = "nonblocking"


@dataclasses.dataclass(frozen=True)
class QoSClass:
    """One traffic class.

    ``mode`` overrides the engine's ``AdmissionPolicy`` gate mode for
    this class (``None`` inherits it); ``occupancy_hi``/``occupancy_lo``
    override the fused decision's admission band per lane (``None``
    inherits the policy scalars); ``deadline_s`` is the default
    admission-to-enqueue budget stamped onto requests that carry none.
    ``patient`` marks the class a bulkhead donor (see module doc).
    """
    name: str
    patient: bool = False
    mode: Optional[str] = None            # 'shed' | 'defer' | None=inherit
    occupancy_hi: Optional[float] = None
    occupancy_lo: Optional[float] = None
    deadline_s: Optional[float] = None

    def __post_init__(self):
        if not self.name or not isinstance(self.name, str):
            raise ValueError("QoS class needs a non-empty string name")
        if self.mode not in (None, "shed", "defer"):
            raise ValueError(f"bad admission mode {self.mode!r}")
        for band in (self.occupancy_hi, self.occupancy_lo):
            if band is not None and not (0.0 <= band <= 1.0):
                raise ValueError(
                    f"occupancy band {band!r} outside [0, 1]")
        if (self.occupancy_hi is not None and self.occupancy_lo is not None
                and self.occupancy_lo > self.occupancy_hi):
            raise ValueError("occupancy_lo above occupancy_hi")


_LOCK = threading.Lock()
_REGISTRY: dict[str, QoSClass] = {}


def register_qos_class(cls: QoSClass, *, replace: bool = False) -> QoSClass:
    """Add a class to the registry (thread-safe).  Re-registering an
    existing name requires ``replace=True`` — silently shadowing a live
    class would change gate modes under running engines."""
    with _LOCK:
        if cls.name in _REGISTRY and not replace:
            raise ValueError(
                f"QoS class {cls.name!r} already registered "
                "(pass replace=True to redefine it)")
        _REGISTRY[cls.name] = cls
    return cls


def qos_class(name: str) -> QoSClass:
    with _LOCK:
        try:
            return _REGISTRY[name]
        except KeyError:
            raise KeyError(
                f"unknown QoS class {name!r} — registered: "
                f"{sorted(_REGISTRY)}") from None


def qos_classes() -> tuple[str, ...]:
    """Registered class names (registration order)."""
    with _LOCK:
        return tuple(_REGISTRY)


# -- built-ins ---------------------------------------------------------------
register_qos_class(QoSClass(BLOCKING, patient=False))
register_qos_class(QoSClass(
    NONBLOCKING, patient=True, mode="shed",
    occupancy_hi=0.6, occupancy_lo=0.3))
