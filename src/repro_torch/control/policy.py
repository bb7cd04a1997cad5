"""Control policies, first part: the decision knobs and the policy
objects.

The same as the JAX package's ``repro.control.policy`` for
``ControlConfig``, the shared target functions (numpy here) and the
policy objects ``ReplicaPolicy``, ``BufferPolicy``, ``AdmissionPolicy``,
``SLOPolicy`` and ``PolicySet`` — the advisory surface the serving
engine reads (``Engine.recommended_queue_capacity``).  The fused
per-tick decision (``control_decide``, ``ControlState``, its step math)
and the loop that runs it are not ported yet (ROADMAP.md, Queue 1
item 6).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.controller import (BufferAutotuner,
                                         ParallelismController,
                                         StragglerDetector)

__all__ = [
    "ControlConfig", "ReplicaPolicy", "BufferPolicy", "AdmissionPolicy",
    "SLOPolicy", "PolicySet",
]


@dataclasses.dataclass(frozen=True)
class ControlConfig:
    """Static decision knobs (hashable).

    The replica / capacity knobs mirror ``ParallelismController`` and
    ``BufferAutotuner`` so a policy built from existing controllers
    decides exactly what the advisory APIs recommend.
    """
    # replicas (ParallelismController knobs)
    headroom: float = 1.2
    max_replicas: int = 64
    # capacity (BufferAutotuner knobs)
    target_frac: float = 0.99
    resize_factor: float = 1.5
    min_capacity: int = 4
    max_capacity: int = 1 << 20
    search_max_k: int = 1 << 16
    # admission (shed/defer state machine)
    collapse_frac: float = 0.5     # mu below this x decayed peak => collapsed
    recover_frac: float = 0.75     # mu above this x peak re-opens the gate
    occupancy_hi: float = 0.9      # queue fill fraction that arms shedding
    occupancy_lo: float = 0.5      # fill fraction that (with recovery) reopens
    straggler_frac: float = 0.8    # mu below this x fleet median => straggler
    min_ready: int = 4             # streams needed before the median is used
    peak_decay: float = 0.995      # per-tick decay of the tracked peak rate
    # saturation escalation: a persistently full queue blocks the
    # producer, so true demand is unobservable (the paper's Pr[WRITE]
    # collapses and arrival periods are discarded) — the only sound
    # move is multiplicative scale-up until demand becomes visible
    saturation_frac: float = 0.8   # tail blocked fraction => saturated
    saturation_growth: float = 2.0  # replica multiplier while saturated
    # demand probe (scale-down of the escalated/stale regime): an
    # arrival estimate whose stream went quiet never re-converges (the
    # epoch freezes at the old high level while fresh near-zero samples
    # fold into the window), so escalated replicas would ratchet.  A
    # queue whose provision is escalation-driven or whose demand signal
    # went stale probes: every ``probe_period_ticks`` the admission gate
    # is forced open and capacity/replicas held for
    # ``probe_window_ticks`` so real demand (if any) becomes observable
    # again; a window that stays dark end-to-end decays replicas by
    # ``saturation_growth`` (AIMD's multiplicative decrease).
    stale_frac: float = 0.5        # window mean below this x gated lam => stale
    probe_period_ticks: int = 16   # ticks between probe windows
    probe_window_ticks: int = 4    # gate-open ticks per probe window
    # SLO / error-budget leg (multi-window burn rate a la the SRE
    # runbooks): per-queue latency targets arrive as a queue-padded
    # operand (NaN = no SLO); the fraction of the last window's
    # observations over target, divided by the budget fraction, is the
    # instantaneous burn rate, folded into fast (~5-tick) and slow
    # (~60-tick) EMAs carried in ControlState.  Both windows hot =>
    # the replica leg escalates (latency pressure scales the stage even
    # when rates balance); a fast burn above ``slo_shed_burn`` arms the
    # admission gate (the budget is burning too fast to scale out of).
    slo_enabled: bool = False
    slo_budget_frac: float = 0.01  # error budget: frac of traffic allowed over
    slo_fast_ticks: int = 5        # fast burn EMA window (control ticks)
    slo_slow_ticks: int = 60       # slow burn EMA window (control ticks)
    slo_burn_hi: float = 1.0       # both EMAs above => SLO-hot (escalate)
    slo_burn_lo: float = 0.5       # fast EMA below => SLO-hot releases
    slo_shed_burn: float = 6.0     # fast EMA above => arm admission
    # gating
    confirm_ticks: int = 2         # consecutive agreeing ticks before acting
    cooldown_ticks: int = 4        # ticks a queue rests after an actuation
    block_q: int = 256             # queue-axis padding block
    # which policy legs are live (PolicySet sets these): a disabled
    # leg's phantom decisions must not fire or burn cooldown — an
    # admission-only engine under overload would otherwise have its
    # resizes throttled by replica decisions nobody actuates
    replica_enabled: bool = True
    buffer_enabled: bool = True
    admission_enabled: bool = True


# -- shared target functions (advice == actuation) ---------------------------
#
# Written against an ``xp`` array namespace, as in the JAX package, which
# evaluates them with numpy for its advisory readouts and traces them
# into its fused decision.

def _replica_targets(cfg: ControlConfig, lam, mu, replicas, xp=np,
                     headroom=None, max_reps=None):
    """``ParallelismController.replicas_fleet``, normalized by the live
    replica count: the monitored ``mu`` is the *aggregate* consumption
    rate of all current replicas, so one replica is worth
    ``mu / replicas`` and the stage needs ``ceil(headroom * lam /
    (mu / replicas))`` copies (identical to the scalar formula when
    replicas == 1).  ``max_replicas`` when the rate is unobservable.
    ``headroom``/``max_reps`` may be (Q,) arrays — the multi-tenant
    per-queue overrides — defaulting to the config scalars."""
    hr = cfg.headroom if headroom is None else headroom
    mr = cfg.max_replicas if max_reps is None else max_reps
    mu_per = mu / xp.maximum(replicas.astype(xp.float32), 1.0)
    n = xp.ceil(hr * lam / xp.where(mu_per > 0, mu_per, 1.0))
    n = xp.where(mu_per <= 0, mr, n)
    return xp.clip(n, 1, mr).astype(xp.int32)


def _capacity_targets(cfg: ControlConfig, lam, mu, cv2, current, xp=np):
    """``optimal_buffer_size``'s answer in closed form: the smallest K
    whose M/M/1/K (or, for cv2 < 0.5, M/D/1/K) accepted throughput
    reaches ``target_frac * min(lam, mu)``.

    The search in ``core.queueing`` brackets the monotone throughput
    curve with ~33 gallop+bisect evaluations — fine per resize event,
    but ~70 pow-heavy passes over (Q,) inside a per-tick decision.  The
    blocking condition inverts exactly
    instead: with f = target_frac, b = 1 - f*min(lam,mu)/lam and
    x = rho^K, ``P_K <= b`` is linear in x, giving x* = (1-f)/(1-f*rho)
    for rho < 1 and (1 - f/rho)/(1-f) for rho > 1, so

        K* = ceil(log(x*) / log(rho))        (rho -> 1: K* = f/(1-f))

    and the M/D/1/K case maps through its K_eff = 2K - 1 exponent
    correction.  Agrees with the search everywhere except occasional
    +/-1-slot float boundaries (regression-tested); unobservable-rate
    queues keep their current capacity."""
    f = cfg.target_frac
    rho = lam / xp.where(mu > 0, mu, 1.0)
    near1 = xp.abs(rho - 1.0) < 1e-6
    # floor keeps the (masked-out) rho=0 lane finite so the numpy form
    # computes warning-free; selected lanes are never floored
    safe_rho = xp.where(near1, 0.5,
                        xp.maximum(rho, 1e-30)).astype(xp.float32)
    xstar = xp.where(rho < 1.0,
                     (1.0 - f) / (1.0 - f * safe_rho),
                     (1.0 - f / safe_rho) / (1.0 - f))
    ke = xp.log(xstar) / xp.log(safe_rho)      # continuous exponent K
    ke = xp.where(near1, f / (1.0 - f), ke)
    k_mm = xp.ceil(ke)
    k_md = xp.ceil((ke + 1.0) / 2.0)           # K_eff = 2K - 1
    k = xp.where(cv2 >= 0.5, k_mm, k_md)
    k = xp.clip(k, cfg.min_capacity, cfg.max_capacity)
    return xp.where((lam > 0) & (mu > 0), k,
                    current).astype(xp.int32)


# -- policy objects: the advisory surface over the same math -----------------

class ReplicaPolicy:
    """Stage-duplication policy.  ``targets`` is the advisory readout,
    the same expression the JAX package's fused decision computes.
    Knobs come from (and stay in sync with) a
    ``ParallelismController``."""

    def __init__(self, ctrl: Optional[ParallelismController] = None):
        self.ctrl = ctrl or ParallelismController()

    def config_kwargs(self) -> dict:
        return {"headroom": self.ctrl.headroom,
                "max_replicas": self.ctrl.max_replicas}

    def targets(self, lam, mu, replicas=1) -> np.ndarray:
        """(Q,) replica targets.  ``mu`` is the measured aggregate stage
        rate; pass the live ``replicas`` it was measured at (default 1,
        the scalar-formula case) so the per-copy rate normalizes.
        Evaluated in numpy, as the JAX package's advisory readout is."""
        cfg = ControlConfig(**self.config_kwargs())
        q = np.shape(np.asarray(lam))[0]
        reps = np.broadcast_to(np.asarray(replicas, np.int32), (q,))
        return _replica_targets(
            cfg, np.asarray(lam, np.float32),
            np.asarray(mu, np.float32), reps, np)


class BufferPolicy:
    """Queue-capacity policy over ``BufferAutotuner``'s analytic sizing
    (and its hysteresis band, applied inside the fused decision)."""

    def __init__(self, tuner: Optional[BufferAutotuner] = None):
        self.tuner = tuner or BufferAutotuner()

    def config_kwargs(self) -> dict:
        t = self.tuner
        return {"target_frac": t.target_frac,
                "resize_factor": t.resize_factor,
                "min_capacity": t.min_capacity,
                "max_capacity": t.max_capacity}

    def targets(self, lam, mu, current, cv2=1.0) -> np.ndarray:
        cfg = ControlConfig(**self.config_kwargs())
        with np.errstate(divide="ignore", invalid="ignore"):
            return _capacity_targets(
                cfg, np.asarray(lam, np.float32),
                np.asarray(mu, np.float32),
                np.asarray(cv2, np.float32),
                np.asarray(current, np.int32), np)


class AdmissionPolicy:
    """Admission gate policy: shed (reject now) or defer (block until
    the gate reopens) when a stream's service rate collapses while its
    queue runs hot.  The straggler leg shares ``StragglerDetector``'s
    threshold semantics (below ``straggler_frac`` x fleet median)."""

    def __init__(self, detector: Optional[StragglerDetector] = None, *,
                 mode: str = "shed", collapse_frac: float = 0.5,
                 recover_frac: float = 0.75, occupancy_hi: float = 0.9,
                 occupancy_lo: float = 0.5):
        if mode not in ("shed", "defer"):
            raise ValueError(f"bad admission mode {mode!r}")
        self.detector = detector or StragglerDetector()
        self.mode = mode
        self.collapse_frac = collapse_frac
        self.recover_frac = recover_frac
        self.occupancy_hi = occupancy_hi
        self.occupancy_lo = occupancy_lo

    def config_kwargs(self) -> dict:
        return {"collapse_frac": self.collapse_frac,
                "recover_frac": self.recover_frac,
                "occupancy_hi": self.occupancy_hi,
                "occupancy_lo": self.occupancy_lo,
                "straggler_frac": self.detector.threshold,
                "min_ready": self.detector.min_hosts}


class SLOPolicy:
    """Latency-SLO / error-budget policy (the burn-rate leg).

    ``target_s`` is the default per-queue latency target in seconds
    (scalar, (Q,) array, or None to rely entirely on actuator-supplied
    targets — ``serve.Engine`` derives per-lane targets from its QoS
    class deadlines).  ``budget_frac`` is the error budget: the
    fraction of observations allowed over target; the burn rate is
    budget consumed per unit budgeted (1.0 = burning exactly at
    budget).  Fast/slow window lengths and thresholds follow the
    multi-window burn-rate runbooks: escalate replicas when both
    windows exceed ``burn_hi``; arm admission when the fast window
    exceeds ``shed_burn`` (too hot to scale out of)."""

    def __init__(self, target_s=None, *, budget_frac: float = 0.01,
                 fast_ticks: int = 5, slow_ticks: int = 60,
                 burn_hi: float = 1.0, burn_lo: float = 0.5,
                 shed_burn: float = 6.0):
        self.target_s = target_s
        self.budget_frac = float(budget_frac)
        self.fast_ticks = int(fast_ticks)
        self.slow_ticks = int(slow_ticks)
        self.burn_hi = float(burn_hi)
        self.burn_lo = float(burn_lo)
        self.shed_burn = float(shed_burn)

    def config_kwargs(self) -> dict:
        return {"slo_enabled": True,
                "slo_budget_frac": self.budget_frac,
                "slo_fast_ticks": self.fast_ticks,
                "slo_slow_ticks": self.slow_ticks,
                "slo_burn_hi": self.burn_hi,
                "slo_burn_lo": self.burn_lo,
                "slo_shed_burn": self.shed_burn}

    def targets(self, q: int) -> np.ndarray:
        """(Q,) default latency targets (NaN = no SLO) — the loop's
        sense step overlays actuator-supplied per-queue targets."""
        if self.target_s is None:
            return np.full(q, np.nan, np.float32)
        t = np.asarray(self.target_s, np.float32)
        return np.broadcast_to(t, (q,)).copy() if t.ndim == 0 else t


@dataclasses.dataclass
class PolicySet:
    """The policies one control loop evaluates (any may be None), merged
    into one ``ControlConfig``."""
    replica: Optional[ReplicaPolicy] = None
    buffer: Optional[BufferPolicy] = None
    admission: Optional[AdmissionPolicy] = None
    slo: Optional[SLOPolicy] = None
    confirm_ticks: int = 2
    cooldown_ticks: int = 4
    block_q: int = 256
    probe_period_ticks: int = 16
    probe_window_ticks: int = 4

    def control_config(self) -> ControlConfig:
        kw: dict = {"confirm_ticks": self.confirm_ticks,
                    "cooldown_ticks": self.cooldown_ticks,
                    "block_q": self.block_q,
                    "probe_period_ticks": self.probe_period_ticks,
                    "probe_window_ticks": self.probe_window_ticks,
                    "replica_enabled": self.replica is not None,
                    "buffer_enabled": self.buffer is not None,
                    "admission_enabled": self.admission is not None}
        for p in (self.replica, self.buffer, self.admission, self.slo):
            if p is not None:
                kw.update(p.config_kwargs())
        return ControlConfig(**kw)
