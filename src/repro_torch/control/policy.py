"""Control policies: one fused decision step for the whole fleet.

The port of the JAX package's ``repro.control.policy``.  The paper
measures non-blocking service rates online so the run-time can re-tune
the application while it runs; the policies here turn the gated (Q,)
fleet estimates into actuation decisions.  Three policy families ride
one evaluation: **replicas** (``ceil(headroom * lambda / mu)``),
**capacity** (the analytic M/M/1/K / M/D/1/K inversion shared with
``BufferAutotuner``) and **admission** (shed or defer when a stream's
service rate collapses while its queue runs hot), plus the SLO
burn-rate leg.  Raw targets are not actions: the decision wraps them in
a gating state machine (readiness, a confirmation counter, capacity
hysteresis, a post-actuation cooldown, the demand probe), and the whole
thing — targets and gates for every queue — is one ``control_decide``
per control tick.

``_step_math`` is written once against an array namespace and runs two
ways: ``impl="numpy"`` on the host, and ``impl="jit"`` as torch ops on
the state's device — on the card one CUDA graph per (config, padded
queue count), captured once and replayed for every decision.  The same
target functions back the advisory readouts
(``Pipeline.recommended_replicas``,
``Engine.recommended_queue_capacity``), so advice and actuation cannot
disagree.
"""

from __future__ import annotations

import dataclasses
import threading
import types
import weakref
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.controller import (BufferAutotuner,
                                         ParallelismController,
                                         StragglerDetector)
from repro_torch.core.device import resolve_device

__all__ = [
    "ControlConfig", "ControlState", "Decision",
    "control_init", "control_decide", "control_decide_trace_count",
    "ReplicaPolicy", "BufferPolicy", "AdmissionPolicy", "SLOPolicy",
    "PolicySet",
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



class ControlState(NamedTuple):
    """Per-queue gating state carried across control ticks: numpy
    arrays from the ``"numpy"`` form, torch tensors on the decision's
    device from the ``"jit"`` form (donated into the next decision like
    ``FleetMonitorState`` is into the next monitor dispatch)."""
    cooldown: Any      # (Q,) i32  ticks until the queue may act again
    rep_agree: Any     # (Q,) i32  signed consecutive-want counter
    cap_agree: Any     # (Q,) i32  signed consecutive-want counter
    shedding: Any      # (Q,) bool admission gate currently shut
    peak_mu: Any       # (Q,) f32  decayed peak service rate seen
    escalated: Any     # (Q,) bool provision last set by escalation
    probe_timer: Any   # (Q,) i32  ticks into the probe cycle
    burn_fast: Any     # (Q,) f32  fast-window SLO burn-rate EMA
    burn_slow: Any     # (Q,) f32  slow-window SLO burn-rate EMA
    slo_hot: Any       # (Q,) bool SLO-escalation memory (hysteresis)


class Decision(NamedTuple):
    """One control tick's verdict for every queue (numpy arrays)."""
    target_replicas: Any   # (Q,) i32
    scale_mask: Any        # (Q,) bool  apply target_replicas now
    target_caps: Any       # (Q,) i32
    resize_mask: Any       # (Q,) bool  apply target_caps now
    shed: Any              # (Q,) bool  admission gate shut
    straggler: Any         # (Q,) bool  below fleet-median threshold
    probing: Any           # (Q,) bool  gate-open demand-probe window
    slo_hot: Any           # (Q,) bool  burn-rate escalation active


def control_init(cfg: ControlConfig, n: int, device="cuda") -> ControlState:
    """The neutral gating state for ``n`` queues, as tensors on
    ``device`` (the card by default; ``device="cpu"`` for the host)."""
    dev = resolve_device(device)

    def z(dtype):
        return torch.zeros((n,), dtype=dtype, device=dev)

    return ControlState(
        cooldown=z(torch.int32), rep_agree=z(torch.int32),
        cap_agree=z(torch.int32), shedding=z(torch.bool),
        peak_mu=z(torch.float32), escalated=z(torch.bool),
        probe_timer=z(torch.int32), burn_fast=z(torch.float32),
        burn_slow=z(torch.float32), slo_hot=z(torch.bool))


_TRACE_COUNT = [0]


def control_decide_trace_count() -> int:
    """Builds of the ``"jit"`` decision form: CUDA-graph captures on the
    card, cache-entry builds on the CPU — one per (config, padded queue
    count, device).  The ragged-fleet no-rebuild regression hook, as
    the JAX package counts its traces."""
    return _TRACE_COUNT[0]


# -- array namespaces ----------------------------------------------------------
#
# ``_step_math`` and the target functions are written once, against an
# ``xp`` namespace, and run two ways: with ``_NP`` (numpy, the host form)
# and with ``_torch_xp(device)`` (torch ops on the decision's device).
# Numpy's weak Python scalars and torch's differ in two places the shims
# settle: torch arrays have no ``.astype`` and ``torch.clamp`` takes
# bounds of one kind, and torch divides by a Python number (and divides a
# Python number by a tensor) through a reciprocal, one rounding off a true
# division on the card.  The math therefore divides only array by array,
# with constants made by ``xp.const`` (a float32 scalar: numpy's own, or a
# 0-dim tensor on the device), which leaves the numpy form's rounding as
# it was.

_NP = types.SimpleNamespace(
    float32=np.float32, int32=np.int32,
    astype=lambda x, dt: x.astype(dt), const=np.float32,
    where=np.where, maximum=np.maximum, minimum=np.minimum, clip=np.clip,
    ceil=np.ceil, abs=np.abs, log=np.log, isnan=np.isnan, sum=np.sum,
    zeros_like=np.zeros_like)


def _torch_xp(device: torch.device) -> types.SimpleNamespace:
    def const(v):
        # a fill kernel, not a host copy: capturable in a CUDA graph
        return torch.full((), float(v), dtype=torch.float32, device=device)

    def _bound(v, like):
        if torch.is_tensor(v):
            return v.to(like.dtype)
        return torch.full((), v, dtype=like.dtype, device=like.device)

    def maximum(a, b):
        if not torch.is_tensor(b):
            return torch.clamp(a, min=b)
        if not torch.is_tensor(a):
            return torch.clamp(b, min=a)
        return torch.maximum(a, b)

    def minimum(a, b):
        if not torch.is_tensor(b):
            return torch.clamp(a, max=b)
        if not torch.is_tensor(a):
            return torch.clamp(b, max=a)
        return torch.minimum(a, b)

    def clip(x, lo, hi):
        # np.clip(x, lo, hi) == minimum(maximum(x, lo), hi); every bound
        # here is an integer well inside float32's exact range
        return torch.minimum(torch.maximum(x, _bound(lo, x)), _bound(hi, x))

    return types.SimpleNamespace(
        float32=torch.float32, int32=torch.int32,
        astype=lambda x, dt: x.to(dt), const=const,
        where=torch.where, maximum=maximum, minimum=minimum, clip=clip,
        ceil=torch.ceil, abs=torch.abs, log=torch.log, isnan=torch.isnan,
        sum=torch.sum, zeros_like=torch.zeros_like)


# -- shared target functions (advice == actuation) ---------------------------

def _replica_targets(cfg: ControlConfig, lam, mu, replicas, xp=_NP,
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
    mu_per = mu / xp.maximum(xp.astype(replicas, xp.float32), 1.0)
    n = xp.ceil(hr * lam / xp.where(mu_per > 0, mu_per, 1.0))
    n = xp.where(mu_per <= 0, mr, n)
    return xp.astype(xp.clip(n, 1, mr), xp.int32)


def _capacity_targets(cfg: ControlConfig, lam, mu, cv2, current, xp=_NP):
    """``optimal_buffer_size``'s answer in closed form: the smallest K
    whose M/M/1/K (or, for cv2 < 0.5, M/D/1/K) accepted throughput
    reaches ``target_frac * min(lam, mu)``.

    With f = target_frac and x = rho^K the blocking condition is linear
    in x, giving x* = (1-f)/(1-f*rho) for rho < 1 and (1 - f/rho)/(1-f)
    for rho > 1, so

        K* = ceil(log(x*) / log(rho))        (rho -> 1: K* = f/(1-f))

    and the M/D/1/K case maps through its K_eff = 2K - 1 exponent
    correction.  Agrees with the search in ``core.queueing`` everywhere
    except occasional +/-1-slot float boundaries, where the continuous
    exponent sits on an integer; unobservable-rate queues keep their
    current capacity."""
    f = cfg.target_frac
    rho = lam / xp.where(mu > 0, mu, 1.0)
    near1 = xp.abs(rho - 1.0) < 1e-6
    # floor keeps the (masked-out) rho=0 lane finite so the numpy form
    # computes warning-free; selected lanes are never floored
    safe_rho = xp.astype(xp.where(near1, 0.5, xp.maximum(rho, 1e-30)),
                         xp.float32)
    xstar = xp.where(rho < 1.0,
                     xp.const(1.0 - f) / (1.0 - f * safe_rho),
                     (1.0 - xp.const(f) / safe_rho) / xp.const(1.0 - f))
    ke = xp.log(xstar) / xp.log(safe_rho)      # continuous exponent K
    ke = xp.where(near1, f / (1.0 - f), ke)
    k_mm = xp.ceil(ke)
    k_md = xp.ceil((ke + 1.0) / 2.0)           # K_eff = 2K - 1
    k = xp.where(cv2 >= 0.5, k_mm, k_md)
    k = xp.clip(k, cfg.min_capacity, cfg.max_capacity)
    return xp.astype(xp.where((lam > 0) & (mu > 0), k, current), xp.int32)


def _step_math(xp, cfg: ControlConfig, state: ControlState, lam, mu,
               ready, replicas, rep_basis, caps, cv2, occupancy,
               saturated, scalable, fleet_med, stale, faulty, leg_rep,
               leg_buf, leg_adm, headroom, max_reps, occ_hi, occ_lo,
               pressure, slo_target, over_frac):
    """The fused decision, once, against either array namespace (the
    JAX package's ``_step_math``; its comments there explain each leg).

    ``leg_rep``/``leg_buf``/``leg_adm`` are the per-queue tenant masks,
    ``headroom``/``max_reps`` the per-queue replica-knob overrides.
    ``stale`` marks queues whose arrival estimate froze while the stream
    went quiet (the demand probe then owns the queue); ``faulty`` is the
    degraded-mode leg (admission forced shut, replica/buffer legs held).
    ``occ_hi``/``occ_lo``/``pressure`` are the class-aware admission
    bands and sibling-lane urgency; ``slo_target``/``over_frac`` feed
    the burn-rate leg, which is a static branch on ``cfg.slo_enabled``.
    """
    lam = xp.astype(lam, xp.float32)
    mu = xp.astype(mu, xp.float32)
    cv2 = xp.astype(cv2, xp.float32)
    occ = xp.astype(occupancy, xp.float32)
    # demand is usable only when the head estimate is, the arrival leg
    # reports, and the estimate is fresh
    known = ready & (lam > 0) & ~stale

    # -- targets: mu is normalized by the replica count in effect when
    # the estimate was produced (rep_basis), not the current one
    rep_formula = _replica_targets(cfg, lam, mu, rep_basis, xp,
                                   headroom, max_reps)
    escalated = xp.astype(xp.clip(
        xp.ceil(xp.astype(replicas, xp.float32) * cfg.saturation_growth),
        1, max_reps), xp.int32)

    # -- SLO burn-rate leg (multi-window error-budget consumption) ------
    if cfg.slo_enabled:
        tgt = xp.astype(slo_target, xp.float32)
        have_slo = ~xp.isnan(tgt)
        # an empty window (NaN) burns nothing
        ovf = xp.astype(over_frac, xp.float32)
        inst = xp.where(xp.isnan(ovf), 0.0, ovf) \
            / xp.const(max(cfg.slo_budget_frac, 1e-9))
        a_f = xp.const(2.0 / (cfg.slo_fast_ticks + 1.0))
        a_s = xp.const(2.0 / (cfg.slo_slow_ticks + 1.0))
        burn_fast = xp.where(
            have_slo, (1.0 - a_f) * state.burn_fast + a_f * inst, 0.0)
        burn_slow = xp.where(
            have_slo, (1.0 - a_s) * state.burn_slow + a_s * inst, 0.0)
        # hot needs both windows over; it releases once the fast cools
        slo_hot = have_slo & xp.where(
            state.slo_hot, burn_fast > cfg.slo_burn_lo,
            (burn_fast > cfg.slo_burn_hi)
            & (burn_slow > cfg.slo_burn_hi))
        shed_slo = have_slo & (burn_fast >= cfg.slo_shed_burn)
        # scale-down freeze while the slow window remembers a burn
        slo_dn_hold = have_slo & (burn_slow > cfg.slo_burn_lo)
    else:
        burn_fast = state.burn_fast
        burn_slow = state.burn_slow
        slo_hot = xp.zeros_like(saturated)
        shed_slo = slo_hot
        have_slo = slo_hot
        slo_dn_hold = slo_hot

    # -- demand probe: scale-down for the escalated / stale regime ------
    esc = (state.escalated | (saturated & ready)) & ~(known & ~saturated)
    elig = (esc | stale) & ~known & ~saturated & leg_rep & scalable \
        & (replicas > 1) & ~faulty
    timer = xp.where(elig, state.probe_timer + 1, 0)
    window_end = cfg.probe_period_ticks + cfg.probe_window_ticks
    probing = elig & (timer > cfg.probe_period_ticks)
    decay = elig & (timer >= window_end)
    timer = xp.where(timer >= window_end, 0, timer)
    decayed = xp.astype(xp.clip(
        xp.ceil(xp.astype(replicas, xp.float32)
                / xp.const(cfg.saturation_growth)),
        1, max_reps), xp.int32)

    rep_t = xp.where(decay, decayed,
                     xp.where(saturated & ready, escalated,
                              xp.where(known, rep_formula, replicas)))
    rep_t = xp.where(slo_hot, xp.maximum(rep_t, escalated), rep_t)
    rep_t = xp.where(have_slo & (rep_t < replicas),
                     xp.maximum(rep_t, decayed), rep_t)
    cap_t = _capacity_targets(cfg, lam, mu, cv2, caps, xp)

    # -- replica gating: confirmation counter + cooldown ----------------
    can_scale = scalable & leg_rep & ~faulty
    want_up = (rep_t > replicas) & (known | (saturated & ready)
                                    | slo_hot) \
        & can_scale & ~probing
    want_dn = (rep_t < replicas) & known & ~saturated & ~slo_hot \
        & ~slo_dn_hold & can_scale & ~probing
    rep_agree = xp.where(
        want_up, xp.maximum(state.rep_agree, 0) + 1,
        xp.where(want_dn, xp.minimum(state.rep_agree, 0) - 1, 0))
    scale = ((xp.abs(rep_agree) >= cfg.confirm_ticks)
             & (state.cooldown <= 0) & ~probing) | decay

    # -- capacity gating: hysteresis band, confirmation, cooldown -------
    ratio = xp.astype(cap_t, xp.float32) \
        / xp.maximum(xp.astype(caps, xp.float32), 1.0)
    outside = (ratio >= cfg.resize_factor) \
        | (ratio <= 1.0 / cfg.resize_factor)
    want_grow = known & outside & (cap_t > caps) & ~saturated \
        & leg_buf & ~probing & ~faulty
    want_shrink = known & outside & (cap_t < caps) & ~saturated \
        & leg_buf & ~probing & ~faulty
    cap_agree = xp.where(
        want_grow, xp.maximum(state.cap_agree, 0) + 1,
        xp.where(want_shrink, xp.minimum(state.cap_agree, 0) - 1, 0))
    resize = (xp.abs(cap_agree) >= cfg.confirm_ticks) \
        & (state.cooldown <= 0)

    # -- admission: peak collapse + fleet-median straggler --------------
    peak = xp.maximum(state.peak_mu * cfg.peak_decay,
                      xp.where(ready, mu, 0.0))
    n_ready = xp.sum(ready)
    straggler = ready & (n_ready >= cfg.min_ready) \
        & (mu < cfg.straggler_frac * fleet_med)
    collapsed = ready & (mu < cfg.collapse_frac * peak)
    exhausted = saturated & ready & (replicas >= max_reps)
    hi = xp.astype(occ_hi, xp.float32)
    lo = xp.astype(occ_lo, xp.float32)
    prs = xp.astype(pressure, xp.float32)
    arm = ((collapsed | straggler | exhausted) & (occ >= hi)) \
        | (prs >= hi) | shed_slo
    recovered = (mu >= cfg.recover_frac * peak) & ~straggler \
        & ~exhausted
    disarm = (recovered | (occ <= lo)) & (prs <= lo) & ~shed_slo
    shed_m = xp.where(state.shedding, ~disarm, arm) & leg_adm
    shed = (shed_m & ~probing) | (faulty & leg_adm)

    acted = scale | resize
    cooldown = xp.where(acted, cfg.cooldown_ticks,
                        xp.maximum(state.cooldown - 1, 0))
    new_state = ControlState(
        cooldown=xp.astype(cooldown, xp.int32),
        rep_agree=xp.astype(xp.where(scale, 0, rep_agree), xp.int32),
        cap_agree=xp.astype(xp.where(resize, 0, cap_agree), xp.int32),
        shedding=shed_m, peak_mu=xp.astype(peak, xp.float32),
        escalated=esc, probe_timer=xp.astype(timer, xp.int32),
        burn_fast=xp.astype(burn_fast, xp.float32),
        burn_slow=xp.astype(burn_slow, xp.float32),
        slo_hot=slo_hot)
    return new_state, Decision(rep_t, scale, cap_t, resize, shed,
                               straggler, probing, slo_hot)


# -- the "jit" form: one cached step per (config, padded Q, device) ----------

# operand rows of the packed staging, with the value padded rows take
# (the JAX package's pad values: padded rows are never ready, never
# scalable, carry no SLO and can never arm admission)
_F32_OPS = (("lam", 0.0), ("mu", 0.0), ("cv2", 1.0), ("occupancy", 0.0),
            ("headroom", 1.0), ("occ_hi", 2.0), ("occ_lo", 0.0),
            ("pressure", 0.0), ("slo_target", np.nan),
            ("over_frac", np.nan))
_I32_OPS = (("replicas", 1), ("rep_basis", 1), ("caps", 1),
            ("max_reps", 1))
_BOOL_OPS = (("ready", False), ("saturated", False), ("scalable", False),
             ("stale", False), ("faulty", False), ("leg_rep", False),
             ("leg_buf", False), ("leg_adm", False))
# state leaves by packed buffer: (leaf, row)
_ST_I32 = ("cooldown", "rep_agree", "cap_agree", "probe_timer")
_ST_F32 = ("peak_mu", "burn_fast", "burn_slow")
_ST_BOOL = ("shedding", "escalated", "slo_hot")


class _DecideStep:
    """The ``"jit"`` form for one (config, padded Q, device).

    Static buffers hold the packed operands (three typed (rows, Qp)
    planes, the fleet median in the float plane's last slot), the
    carried state (three typed planes, one row a leaf) and the packed
    decision.  ``fn`` runs ``_step_math`` on them with torch ops, writes
    the new state back over the old and packs the decision.  On the card
    ``fn`` is captured once as a CUDA graph and every decision replays
    it: the host uploads three operand planes, replays, and reads one
    decision plane back.  On the CPU ``fn`` runs eagerly.
    """

    def __init__(self, cfg: ControlConfig, qp: int, device: torch.device):
        self.cfg, self.qp, self.device = cfg, qp, device
        cuda = device.type == "cuda"

        def host(shape, dtype):
            return torch.zeros(shape, dtype=dtype, pin_memory=cuda)

        def dev(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        nf = len(_F32_OPS)
        self.h_f32 = host((nf * qp + 1,), torch.float32)
        self.h_i32 = host((len(_I32_OPS), qp), torch.int32)
        self.h_bool = host((len(_BOOL_OPS), qp), torch.bool)
        self.h_dec = host((len(Decision._fields), qp), torch.int32)
        if cuda:
            self.d_f32 = dev(self.h_f32.shape, torch.float32)
            self.d_i32 = dev(self.h_i32.shape, torch.int32)
            self.d_bool = dev(self.h_bool.shape, torch.bool)
            self.d_dec = dev(self.h_dec.shape, torch.int32)
        else:                  # the host planes are the operands
            self.d_f32, self.d_i32 = self.h_f32, self.h_i32
            self.d_bool, self.d_dec = self.h_bool, self.h_dec
        self.st = {torch.int32: dev((len(_ST_I32), qp), torch.int32),
                   torch.float32: dev((len(_ST_F32), qp), torch.float32),
                   torch.bool: dev((len(_ST_BOOL), qp), torch.bool)}
        self.rows = {}
        for names, dt in ((_ST_I32, torch.int32), (_ST_F32, torch.float32),
                          (_ST_BOOL, torch.bool)):
            for r, name in enumerate(names):
                self.rows[name] = self.st[dt][r]
        self._out: tuple = ()        # weak refs to the last donated state
        self.lock = threading.Lock()   # one decision at a time
        self.graph = None
        if cuda:
            self._capture()

    # -- the step on the static buffers ----------------------------------
    def fn(self) -> None:
        xp = _torch_xp(self.device)
        qp = self.qp
        f = self.d_f32[:-1].view(len(_F32_OPS), qp)
        ops = {n: f[r] for r, (n, _) in enumerate(_F32_OPS)}
        ops.update({n: self.d_i32[r] for r, (n, _) in enumerate(_I32_OPS)})
        ops.update({n: self.d_bool[r]
                    for r, (n, _) in enumerate(_BOOL_OPS)})
        ops["fleet_med"] = self.d_f32[-1]
        state = ControlState(**{n: self.rows[n]
                                for n in ControlState._fields})
        new, dec = _step_math(xp, self.cfg, state, **ops)
        for name in ControlState._fields:
            self.rows[name].copy_(getattr(new, name))
        for r, a in enumerate(dec):
            self.d_dec[r].copy_(a)

    def _capture(self) -> None:
        side = torch.cuda.Stream(device=self.device)
        cur = torch.cuda.current_stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self.fn()                    # warm-up outside the capture
        cur.wait_stream(side)
        g = torch.cuda.CUDAGraph()
        # thread-local: the monitor thread keeps launching and syncing
        # its own work while the loop thread captures
        with torch.cuda.graph(g, stream=side,
                              capture_error_mode="thread_local"):
            self.fn()
        self.graph = g

    # -- one decision ----------------------------------------------------
    def load(self, q: int, ops: dict) -> None:
        """Pack the (Q,) host operands (and their padding) into the
        staging planes and upload them."""
        qp, nf = self.qp, len(_F32_OPS)
        hf = self.h_f32.numpy()
        f = hf[:-1].reshape(nf, qp)
        for r, (name, fill) in enumerate(_F32_OPS):
            f[r, :q] = ops[name]
            f[r, q:] = fill
        hf[-1] = ops["fleet_med"]
        for plane, spec in ((self.h_i32.numpy(), _I32_OPS),
                            (self.h_bool.numpy(), _BOOL_OPS)):
            for r, (name, fill) in enumerate(spec):
                plane[r, :q] = ops[name]
                plane[r, q:] = fill
        if self.d_f32 is not self.h_f32:
            self.d_f32.copy_(self.h_f32, non_blocking=True)
            self.d_i32.copy_(self.h_i32, non_blocking=True)
            self.d_bool.copy_(self.h_bool, non_blocking=True)

    def _donated(self, state) -> bool:
        out = [r() for r in self._out]
        return (len(out) == len(state)
                and all(a is b for a, b in zip(out, state)))

    def _release(self) -> None:
        """Give the holders of the last donated state their own copy
        before the buffers it aliases are overwritten."""
        for r in self._out:
            t = r()
            if t is not None:
                t.set_(t.clone())
        self._out = ()

    def load_state(self, q: int, state, donate: bool) -> None:
        if donate and self._donated(state):
            return                       # the buffers already hold it
        self._release()
        for name, leaf in zip(ControlState._fields, state):
            row = self.rows[name]
            row[:q].copy_(torch.as_tensor(np.asarray(leaf)
                                          if not torch.is_tensor(leaf)
                                          else leaf))
            row[q:].zero_()

    def run(self) -> None:
        if self.graph is not None:
            self.graph.replay()
            self.h_dec.copy_(self.d_dec, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
        else:
            self.fn()

    def outputs(self, q: int, donate: bool):
        hd = self.h_dec.numpy()
        dec = Decision(*(hd[r, :q].astype(bool) if r not in (0, 2)
                         else hd[r, :q].copy()
                         for r in range(len(Decision._fields))))
        leaves = [self.rows[n][:q] for n in ControlState._fields]
        if not donate:
            return ControlState(*(t.clone() for t in leaves)), dec
        self._out = tuple(weakref.ref(t) for t in leaves)
        return ControlState(*leaves), dec


_STEPS: dict = {}
_STEPS_LOCK = threading.Lock()


def _decide_step(cfg: ControlConfig, qp: int,
                 device: torch.device) -> _DecideStep:
    """The cached ``"jit"`` step for (config, padded Q, device); a miss
    builds it (a CUDA-graph capture on the card) and counts one build."""
    key = (cfg, qp, device)
    with _STEPS_LOCK:
        step = _STEPS.get(key)
        if step is None:
            step = _STEPS[key] = _DecideStep(cfg, qp, device)
            _TRACE_COUNT[0] += 1
        return step


def _host(a) -> np.ndarray:
    """A host numpy array of ``a`` (a tensor on any device, or array-like)."""
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _state_device(state, device) -> torch.device:
    if device is not None:
        return resolve_device(device)
    for leaf in state:
        if torch.is_tensor(leaf):
            return leaf.device
    return torch.device("cpu")


def control_decide(cfg: ControlConfig, state: ControlState, *,
                   lam, mu, ready, replicas, caps, cv2=1.0, occupancy=0.0,
                   rep_basis=None, saturated=None, scalable=None,
                   stale=None, faulty=None, leg_rep=None, leg_buf=None,
                   leg_adm=None, headroom=None, max_replicas=None,
                   occ_hi=None, occ_lo=None, pressure=None,
                   slo_target=None, over_frac=None,
                   impl: str = "auto", donate: bool = True, device=None
                   ) -> tuple[ControlState, Decision]:
    """Evaluate every policy for the whole fleet in one fused pass.

    All per-queue operands are (Q,) host arrays (or scalars, broadcast);
    their meaning and defaults are the JAX package's (``_step_math``
    documents each leg).  ``impl`` selects the execution form of the
    *same* ``_step_math`` source:

    * ``"numpy"``: the host form, run directly; returns numpy state.
    * ``"jit"``: torch ops on the state's device (or ``device``).  The
      queue axis is padded to a ``cfg.block_q`` multiple with rows that
      decide nothing, so ragged fleets share one cached step per
      (config, padded Q, device); on the card that step is one CUDA
      graph, captured once and replayed for every decision.  The fleet
      median of the ready rates is taken on the host, as the JAX package
      does, and uploaded with the operands.
    * ``"auto"``: ``"numpy"`` for state on the CPU (numpy arrays or CPU
      tensors), ``"jit"`` for state on the card.

    The decision comes back as numpy arrays in either form.  Under
    ``"jit"`` with ``donate`` (the default) the returned state aliases
    the cached step's buffers: like the JAX package's donation, the
    caller keeps only the returned state and passes it to the next
    decision, which then uploads no state at all.  A state that is not
    the last one returned is copied in, and the holders of the last one
    get their own copy first, so a second caller cannot clobber it.
    ``donate=False`` returns a state the caller owns.
    """
    lam = np.asarray(lam, np.float32)
    q = lam.shape[0]
    if rep_basis is None:
        rep_basis = replicas
    if saturated is None:
        saturated = np.zeros(q, bool)
    if scalable is None:
        scalable = np.ones(q, bool)
    if stale is None:
        stale = np.zeros(q, bool)
    if faulty is None:
        faulty = np.zeros(q, bool)
    if leg_rep is None:
        leg_rep = cfg.replica_enabled
    if leg_buf is None:
        leg_buf = cfg.buffer_enabled
    if leg_adm is None:
        leg_adm = cfg.admission_enabled
    if headroom is None:
        headroom = cfg.headroom
    if max_replicas is None:
        max_replicas = cfg.max_replicas

    def band(v, default):
        # per-queue occupancy band, NaN = inherit the config scalar
        if v is None:
            return np.float32(default)
        v = np.asarray(v, np.float32)
        return np.where(np.isnan(v), np.float32(default), v)

    occ_hi = band(occ_hi, cfg.occupancy_hi)
    occ_lo = band(occ_lo, cfg.occupancy_lo)
    if pressure is None:
        pressure = 0.0
    if slo_target is None:
        slo_target = np.nan
    if over_frac is None:
        over_frac = np.nan
    # fleet median of the ready service rates, for the straggler leg
    mu_np = np.asarray(mu, np.float32)
    ready_np = np.asarray(ready, bool)
    fleet_med = (float(np.median(mu_np[ready_np]))
                 if ready_np.any() else 0.0)
    dev = _state_device(state, device)
    if impl == "auto":
        impl = "jit" if dev.type == "cuda" else "numpy"

    def npa(a, dt):
        a = np.asarray(a, dt)
        return np.broadcast_to(a, (q,)) if a.ndim == 0 else a

    ops = dict(lam=lam, mu=npa(mu, np.float32), ready=npa(ready, bool),
               replicas=npa(replicas, np.int32),
               rep_basis=npa(rep_basis, np.int32),
               caps=npa(caps, np.int32), cv2=npa(cv2, np.float32),
               occupancy=npa(occupancy, np.float32),
               saturated=npa(saturated, bool),
               scalable=npa(scalable, bool),
               stale=npa(stale, bool), faulty=npa(faulty, bool),
               leg_rep=npa(leg_rep, bool), leg_buf=npa(leg_buf, bool),
               leg_adm=npa(leg_adm, bool),
               headroom=npa(headroom, np.float32),
               max_reps=npa(max_replicas, np.int32),
               occ_hi=npa(occ_hi, np.float32),
               occ_lo=npa(occ_lo, np.float32),
               pressure=npa(pressure, np.float32),
               slo_target=npa(slo_target, np.float32),
               over_frac=npa(over_frac, np.float32))
    if impl == "numpy":
        st = ControlState(*(_host(leaf) for leaf in state))
        # masked-out lanes (mu <= 0 etc.) compute garbage by design and
        # are discarded by the final where, minus the numpy warnings
        with np.errstate(divide="ignore", invalid="ignore"):
            return _step_math(_NP, cfg, st, fleet_med=np.float32(fleet_med),
                              **ops)
    if impl != "jit":
        raise ValueError(f"bad impl {impl!r}")

    b = cfg.block_q
    step = _decide_step(cfg, -(-max(q, 1) // b) * b, dev)
    with step.lock:
        step.load(q, {**ops, "fleet_med": fleet_med})
        step.load_state(q, state, donate)
        step.run()
        return step.outputs(q, donate)


# -- policy objects: the advisory surface over the same math -----------------

class ReplicaPolicy:
    """Stage-duplication policy.  ``targets`` is the advisory readout,
    the same expression the fused decision computes.
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
        Evaluated in numpy, as the advisory readouts are."""
        cfg = ControlConfig(**self.config_kwargs())
        q = np.shape(np.asarray(lam))[0]
        reps = np.broadcast_to(np.asarray(replicas, np.int32), (q,))
        return _replica_targets(
            cfg, np.asarray(lam, np.float32),
            np.asarray(mu, np.float32), reps)


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
                np.asarray(current, np.int32))


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
