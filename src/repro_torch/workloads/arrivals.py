"""Composable workload processes: the rate envelopes scenarios are
built from.

The paper's premise (§I) is that offered load and service cost are
*non-stationary* — the run-time re-tunes because conditions change.
Every validation scenario therefore needs a shaped, reproducible load
path, and hand-rolling `mutate(sim, t)` closures per benchmark (the
pre-foundry state of ``control_bench.py``) does not compose: a diurnal
curve with a flash crowd on top and a correlated surge across tenants
is three closures deep and unseedable.

A :class:`Process` here is a *deterministic* rate envelope ``rate(t)``
over scenario time (periods for the simulated stacks, seconds for the
real-thread soaks — the process does not care).  Randomness lives in
the *sampler* (``SimTandem`` draws poisson/pareto counts from the
envelope under its own seeded rng), so the same scenario replayed with
the same seed reproduces the identical sample path while a different
seed explores the same shape.  Envelopes compose arithmetically::

    lam = Diurnal(base=100, amplitude=60, period=2000) \
        + FlashCrowd(peak=300, at=1200, rise=50, fall=200)
    mu  = Step(before=60, after=15, at=1000) * 1.0

Service-side heavy tails (Pareto item costs — the "one huge item
stalls the stage" regime Nephele-style QoS enforcement must survive)
are a *sampler* property, not an envelope property: see
:class:`ParetoService` vs :class:`PoissonService` in ``.sim``.
"""

from __future__ import annotations

import math

__all__ = ["Process", "Constant", "Step", "Ramp", "Square", "Diurnal",
           "Boxcar", "FlashCrowd", "Sum", "Product", "Clip", "Shift",
           "as_process"]


class Process:
    """A deterministic rate envelope ``rate(t) -> float``.

    Compose with ``+`` (superposed load), ``*`` (modulation by a scalar
    or another envelope), ``.clip(lo, hi)`` and ``.shift(dt)`` (phase
    offset — two tenants sharing one envelope at opposite shifts is the
    anti-correlated pair; sharing it unshifted is the correlated
    surge).
    """

    def rate(self, t: float) -> float:
        raise NotImplementedError

    def __call__(self, t: float) -> float:
        return self.rate(t)

    def __add__(self, other) -> "Process":
        return Sum(self, as_process(other))

    __radd__ = __add__

    def __mul__(self, other) -> "Process":
        return Product(self, as_process(other))

    __rmul__ = __mul__

    def clip(self, lo: float = 0.0, hi: float = float("inf")) -> "Process":
        return Clip(self, lo, hi)

    def shift(self, dt: float) -> "Process":
        return Shift(self, dt)


def as_process(v) -> Process:
    """Lift a number to a :class:`Constant`; pass processes through."""
    if isinstance(v, Process):
        return v
    return Constant(float(v))


class Constant(Process):
    def __init__(self, value: float):
        self.value = float(value)

    def rate(self, t: float) -> float:
        return self.value


class Step(Process):
    """``before`` until ``at``, ``after`` from then on — the mid-run
    kernel-cost/load step the original acceptance scenario uses."""

    def __init__(self, before: float, after: float, at: float):
        self.before, self.after, self.at = (float(before), float(after),
                                            float(at))

    def rate(self, t: float) -> float:
        return self.after if t >= self.at else self.before


class Ramp(Process):
    """Linear drift from ``v0`` at ``t0`` to ``v1`` at ``t1`` (held flat
    outside the window) — the slow-drift scenario's envelope."""

    def __init__(self, v0: float, v1: float, t0: float, t1: float):
        if t1 <= t0:
            raise ValueError("Ramp needs t1 > t0")
        self.v0, self.v1, self.t0, self.t1 = (float(v0), float(v1),
                                              float(t0), float(t1))

    def rate(self, t: float) -> float:
        if t <= self.t0:
            return self.v0
        if t >= self.t1:
            return self.v1
        f = (t - self.t0) / (self.t1 - self.t0)
        return self.v0 + (self.v1 - self.v0) * f


class Square(Process):
    """Alternating ``hi``/``lo`` half-periods — bursty offered load.
    ``phase`` in periods; ``.shift()`` half a period makes the
    anti-correlated partner."""

    def __init__(self, hi: float, lo: float, period: float,
                 phase: float = 0.0):
        if period <= 0:
            raise ValueError("Square needs period > 0")
        self.hi, self.lo = float(hi), float(lo)
        self.period, self.phase = float(period), float(phase)

    def rate(self, t: float) -> float:
        x = ((t + self.phase) % self.period) / self.period
        return self.hi if x < 0.5 else self.lo


class Diurnal(Process):
    """Sinusoidal day curve: ``base + amplitude * sin(2 pi t/period)``,
    floored at 0 — the sustained-soak shape (a compressed day)."""

    def __init__(self, base: float, amplitude: float, period: float,
                 phase: float = 0.0):
        if period <= 0:
            raise ValueError("Diurnal needs period > 0")
        self.base, self.amplitude = float(base), float(amplitude)
        self.period, self.phase = float(period), float(phase)

    def rate(self, t: float) -> float:
        x = 2.0 * math.pi * (t + self.phase) / self.period
        return max(0.0, self.base + self.amplitude * math.sin(x))


class Boxcar(Process):
    """``level`` over ``[t0, t1)``, zero elsewhere — additive burst
    windows (the qos benches superpose one on a base rate)."""

    def __init__(self, level: float, t0: float, t1: float):
        if t1 <= t0:
            raise ValueError("Boxcar needs t1 > t0")
        self.level, self.t0, self.t1 = float(level), float(t0), float(t1)

    def rate(self, t: float) -> float:
        return self.level if self.t0 <= t < self.t1 else 0.0


class FlashCrowd(Process):
    """A flash crowd: rate climbs linearly over ``rise`` to ``peak`` at
    ``at``, then decays exponentially with time constant ``fall``.
    Additive on purpose — superpose it on a base envelope."""

    def __init__(self, peak: float, at: float, rise: float, fall: float):
        if rise <= 0 or fall <= 0:
            raise ValueError("FlashCrowd needs rise > 0 and fall > 0")
        self.peak, self.at = float(peak), float(at)
        self.rise, self.fall = float(rise), float(fall)

    def rate(self, t: float) -> float:
        if t < self.at - self.rise or self.peak <= 0:
            return 0.0
        if t < self.at:
            return self.peak * (1.0 - (self.at - t) / self.rise)
        return self.peak * math.exp(-(t - self.at) / self.fall)


class Sum(Process):
    def __init__(self, a: Process, b: Process):
        self.a, self.b = a, b

    def rate(self, t: float) -> float:
        return self.a.rate(t) + self.b.rate(t)


class Product(Process):
    def __init__(self, a: Process, b: Process):
        self.a, self.b = a, b

    def rate(self, t: float) -> float:
        return self.a.rate(t) * self.b.rate(t)


class Clip(Process):
    def __init__(self, inner: Process, lo: float, hi: float):
        self.inner, self.lo, self.hi = inner, float(lo), float(hi)

    def rate(self, t: float) -> float:
        return min(max(self.inner.rate(t), self.lo), self.hi)


class Shift(Process):
    def __init__(self, inner: Process, dt: float):
        self.inner, self.dt = inner, float(dt)

    def rate(self, t: float) -> float:
        return self.inner.rate(t + self.dt)
