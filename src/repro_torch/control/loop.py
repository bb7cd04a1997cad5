"""The control loop: sense -> decide -> actuate, one fused decision per
tick.  The port of the JAX package's ``repro.control.loop``.

``ControlLoop`` closes the loop the paper's monitoring opens: a
``FleetMonitorService`` continuously estimates every queue's
non-blocking service rate; the loop periodically reads the gated (Q,)
estimate arrays, evaluates the ``PolicySet`` for the whole fleet in
**one** decision (``control_decide``; on the card one CUDA-graph
replay) (targets + confirmation counters +
hysteresis + cooldown + admission state machine — see
``control.policy``), and drives the few queues whose decisions fired
through an *actuator* adapter.  Everything per-tick is O(1) python plus
vectorized array math; the python loop runs only over the (typically
empty) set of fired actions.

The loop runs as its own timer thread, one tick per fused monitor
dispatch by default (``service.period_s * service.chunk_t`` — deciding
faster than estimates refresh would only chase noise), or is ticked
manually (``tick()``) by tests, benchmarks and simulation harnesses.

Actuator adapters are owned by the actuated layer (``streams.Pipeline``
and ``serve.Engine`` each build their own), keeping this package free
of upward dependencies.  An adapter provides:

* ``replicas()`` / ``capacities()`` -> (Q,) current configuration;
* ``occupancy()`` -> (Q,) queue fill fractions (admission only);
* ``scale(i, n)`` / ``resize(i, cap)`` / ``admit(i, shed)`` ->
  outcome string (``'applied'`` | ``'rejected'`` | ``'noop'``) — a
  rejection (e.g. a shrink below the queued item count) is recorded and
  retried naturally on a later tick;
* ``faulty()`` -> (Q,) bool (optional): queues whose consumer stage is
  degraded (crash-looping, retired by the supervisor) — the decision
  dispatch holds their replica/buffer actions and forces admission
  shut, as one extra padded operand (no retraces);
* ``admission_bands()`` -> ((Q,), (Q,)) float (optional): per-queue
  admission occupancy (hi, lo) bands, NaN = inherit the config
  scalars — the QoS per-class occupancy targets;
* ``pressure()`` -> (Q,) float (optional): sibling-lane urgency (a
  patient QoS lane carries the hottest blocking lane's occupancy), so
  patient traffic sheds first under a blocking burst — both ride the
  same fused dispatch as padded operands (no retraces);
* ``slo_targets()`` -> (Q,) float seconds (optional): per-queue latency
  SLO targets, NaN = no target — ``serve.Engine`` derives them from its
  QoS class deadlines; they overlay the ``SLOPolicy`` default and feed
  the burn-rate leg together with the service's windowed
  ``over_fraction`` readout (one more padded operand, no retraces).

The loop is hardened against the failure modes a long-running control
plane actually sees — each is audited in the ``ControlLog`` with an
error code and surfaced via ``health()``:

* **sense**: NaN/Inf gated estimates are quarantined (the last finite
  estimate substitutes, ``E_SENSE_NAN``) so one poisoned readout cannot
  reach the decision math;
* **actuate**: a raising/slow actuator verb is retried with backoff
  under an elapsed-time budget; a final failure is recorded
  (``E_ACT_RAISE``/``E_ACT_SLOW``), admission failures roll the gate
  back so the loop's memory never diverges from the physical gate;
* **decide**: repeated failures of the ``"jit"`` form (the CUDA-graph
  replay on the card) degrade the loop to the numpy host path of the
  *same* ``_step_math`` (``E_JIT_DISPATCH``);
* **monitor**: a watchdog (``watch_monitor``) restarts a dead
  ``FleetMonitorThread`` between ticks — the ``FleetMonitorService``
  holds all estimator state, so the restart loses nothing
  (``E_MONITOR_DEAD``);
* **tick**: any other tick failure is contained (``E_TICK``) — the
  timer thread never dies of one bad tick.

Lock ordering: the hierarchy of
``repro_torch.analysis.lock_order.LOCK_ORDER`` holds here; this loop
acquires at the *loop* rank.  A tick takes ``_lock``, reads the
service one rank down (released before deciding), then actuates
through *sync*-tier leaves — no actuator path re-enters the service,
so ``FleetMonitorService.stop()``/``flush()`` from any other thread
can only interleave between — never deadlock against — a tick
mid-actuation.  Multi-tenant attach/detach (``control.group``) enters
one rank up: the group holds ``ControlLoop._lock`` across the whole
restructure (service mutation, then ``_remap_locked``), so a tick can
never observe a service whose stream set and the loop's per-queue
state arrays disagree.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

import torch

from repro_torch.control.log import ControlLog, ControlRecord
from repro_torch.control.policy import (ControlState, Decision, PolicySet,
                                        _host, control_decide, control_init)

__all__ = ["ControlLoop"]


class ControlLoop(threading.Thread):
    """Closed-loop elastic actuation over one fleet monitor service."""

    def __init__(self, service, policies: PolicySet, actuator, *,
                 log: Optional[ControlLog] = None,
                 period_s: Optional[float] = None,
                 impl: str = "auto", min_sleep_s: float = 2e-4,
                 actuation_retries: int = 2,
                 actuation_backoff_s: float = 2e-3,
                 actuation_timeout_s: float = 0.25,
                 jit_fail_limit: int = 3):
        super().__init__(daemon=True, name="repro-control")
        self.service = service
        self.policies = policies
        self.actuator = actuator
        self.impl = impl
        # the decision runs where the service's estimator state lives:
        # "auto" is the numpy host form for a CPU service and the "jit"
        # form (a CUDA graph) for one on the card
        self.device = getattr(service, "device", torch.device("cpu"))
        self._impl = (impl if impl != "auto" else
                      "jit" if self.device.type == "cuda" else "numpy")
        self.cfg = policies.control_config()
        self.log = log if log is not None else ControlLog()
        # one decision per fused monitor dispatch: estimates only move
        # when a chunk lands, so deciding faster only chases noise.
        # ``FleetMonitorThread`` adapts ``service.period_s`` every tick,
        # so a derived period is re-read each run() iteration — freezing
        # it at construction would drift off the one-decision-per-
        # dispatch cadence (chasing noise when T widens, starving when
        # it narrows).  Only an explicit ``period_s`` stays fixed.
        self._explicit_period = period_s is not None
        self.period_s = (period_s if period_s is not None
                         else service.period_s * service.chunk_t)
        self.min_sleep_s = min_sleep_s
        q = len(service.queues)
        self.n_queues = q
        self.state: ControlState = control_init(self.cfg, q,
                                                device=self.device)
        self.ticks = 0
        self._shed = np.zeros(q, bool)     # last applied admission gates
        # per-queue replica count each mu estimate was measured at: a
        # frozen estimate (starved consumer after a scale-up folds no
        # new samples) keeps its old basis, so the per-copy rate the
        # decision normalizes by cannot drift with the actuation itself
        self._mu_basis = np.ones(q, np.int64)
        self._last_mu = np.full(q, np.nan)
        # cumulative tail blocked/total periods at the previous tick:
        # differenced to detect saturation (demand unobservable)
        self._last_blk = np.zeros(q, np.int64)
        self._last_tot = np.zeros(q, np.int64)
        # -- failure handling ----------------------------------------------
        # sense-side quarantine: last finite gated estimates, substituted
        # for NaN/Inf readings so one poisoned readout cannot reach the
        # decision math (garbage targets actuate like any others)
        self._last_good_mu = np.zeros(q)
        self._last_good_lam = np.zeros(q)
        self.quarantined = 0               # estimates quarantined, ever
        # SLO-leg mirrors for the exporter/health surface: numpy copies
        # refreshed once per tick (never the live state, which aliases
        # the decision's graph buffers), so a scrape thread reads
        # without racing the next decision
        self.slo_burn_fast = np.zeros(q)
        self.slo_burn_slow = np.zeros(q)
        self.slo_targets = np.full(q, np.nan)
        self._slo_hot_prev = np.zeros(q, bool)
        # actuation failure policy: retry with backoff, then record the
        # failure (outcome 'error' + code) and roll back what we can
        self.actuation_retries = int(actuation_retries)
        self.actuation_backoff_s = float(actuation_backoff_s)
        self.actuation_timeout_s = float(actuation_timeout_s)
        self.actuation_errors = 0
        # decision degradation: repeated failures of the "jit" form fall
        # the loop back to the numpy host path of the SAME _step_math
        self.jit_fail_limit = int(jit_fail_limit)
        self._jit_fail = 0
        self.impl_degraded = False
        self.tick_errors = 0               # contained tick failures
        # monitor watchdog (see watch_monitor)
        self._mon_get = None
        self._mon_restart = None
        self.monitor_restarts = 0
        self._lock = threading.Lock()      # serializes tick()/stop()
        self._stop_evt = threading.Event()

    # -- sense -> decide -> actuate ---------------------------------------
    def _current_period(self) -> float:
        """The live tick period: the explicit override, or one decision
        per fused monitor dispatch at the service's *current* adaptive
        sampling period."""
        if not self._explicit_period:
            self.period_s = self.service.period_s * self.service.chunk_t
        return self.period_s

    def warmup(self) -> None:
        """Build the decision step off the tick path (same padded shape
        and config, so it lands in the same cache entry: on the card the
        CUDA-graph capture)."""
        q = self.n_queues
        if q == 0 or self._impl == "numpy":
            return
        z = np.zeros(q)
        control_decide(self.cfg,
                       control_init(self.cfg, q, device=self.device),
                       lam=z, mu=z, ready=np.zeros(q, bool),
                       replicas=np.ones(q), caps=np.ones(q),
                       impl=self._impl, donate=False, device=self.device)

    def tick(self) -> Decision:
        """One sense->decide->actuate pass; safe from any thread."""
        with self._lock:
            return self._tick_locked()

    def _tick_locked(self) -> Decision:
        svc = self.service
        q = self.n_queues
        if q == 0:                         # empty group: nothing to sense
            self.ticks += 1
            zi, zb = np.zeros(0, np.int32), np.zeros(0, bool)
            return Decision(target_replicas=zi, scale_mask=zb,
                            target_caps=zi, resize_mask=zb, shed=zb,
                            straggler=zb, probing=zb, slo_hot=zb)
        # -- sense: one gated readout for both ends ----------------------
        rates = svc.gated_rates()
        mu, lam = rates[:q], rates[q:]
        mu, bad_mu = self._quarantine(mu, self._last_good_mu)
        bad_lam = np.zeros(0, np.int64)
        ready = mu > 0                     # head estimate usable
        tails = slice(q, None)
        if lam.shape[0] == 0:              # ends="head" service: no
            lam = np.zeros(q)              # arrival leg, replica/cap
            saturated = np.zeros(q, bool)
            stale = np.zeros(q, bool)
        else:
            lam, bad_lam = self._quarantine(lam, self._last_good_lam)
            # saturation: the tail leg blocked (queue full) for nearly
            # every period since the last tick — demand is dark,
            # escalate instead
            nb, nt = svc.blocked_counts()
            d_blk = nb[tails] - self._last_blk
            d_tot = nt[tails] - self._last_tot
            self._last_blk, self._last_tot = nb[tails], nt[tails]
            saturated = (d_tot > 0) & (
                d_blk >= self.cfg.saturation_frac * d_tot)
            # staleness: a quiet stream never re-converges, so the gated
            # arrival estimate freezes at its old level while fresh
            # near-zero samples fold into the window — the window mean
            # collapsing far below the gated estimate means the demand
            # signal is stale and the probe (not the formula) owns it
            recent = svc.recent_rates("tail")
            stale = (lam > 0) & (recent < self.cfg.stale_frac * lam)
        n_bad = int(bad_mu.size + bad_lam.size)
        if n_bad:                          # one audit record per tick
            qi = int(bad_mu[0]) if bad_mu.size else int(bad_lam[0])
            self.log.append(ControlRecord(
                tick=self.ticks, t=time.monotonic(), queue=qi,
                policy="sense", observed_lam=float(lam[qi]),
                observed_mu=float(mu[qi]), action="quarantine",
                value=n_bad, outcome="observed", error="E_SENSE_NAN"))
        cv2 = svc.cv2s()
        act = self.actuator
        replicas = np.asarray(act.replicas(), np.int64)
        # queues whose consumer cannot be duplicated (e.g. the pipeline
        # sink drain) are masked out of the replica leg entirely
        scalable = (np.asarray(act.scalable(), bool)
                    if hasattr(act, "scalable") else None)
        caps = np.asarray(act.capacities(), np.int64)
        # degraded-queue mask from the supervised layer (if it has one):
        # faulty queues get replica/buffer actions held and admission
        # forced shut inside the same fused dispatch
        faulty = (np.asarray(act.faulty(), bool)
                  if hasattr(act, "faulty") else None)
        occ = (np.asarray(act.occupancy(), float)
               if self.policies.admission is not None else 0.0)
        # class-aware admission operands (QoS lanes): per-queue
        # occupancy bands (NaN = inherit the config scalars) and
        # sibling-lane pressure — optional like scalable()/faulty(),
        # and queue-padded so a class-less actuator decides identically
        bands = (act.admission_bands()
                 if hasattr(act, "admission_bands") else None)
        occ_hi = occ_lo = None
        if bands is not None:
            occ_hi = np.asarray(bands[0], np.float32)
            occ_lo = np.asarray(bands[1], np.float32)
        pressure = (np.asarray(act.pressure(), float)
                    if hasattr(act, "pressure") else None)
        # SLO leg sense: per-queue latency targets (actuator-supplied
        # targets overlay the SLOPolicy default) and the fraction of
        # the last harvest window over target.  Only sensed when the
        # leg is enabled — SLO-less loops pay nothing here.
        slo_t = over = None
        if self.cfg.slo_enabled:
            p = self.policies.slo
            slo_t = (p.targets(q) if p is not None
                     else np.full(q, np.nan, np.float32))
            if hasattr(act, "slo_targets"):
                t_act = np.asarray(act.slo_targets(), np.float32)
                slo_t = np.where(np.isnan(t_act), slo_t, t_act)
            if hasattr(svc, "over_fraction"):
                over = svc.over_fraction(slo_t, which="head")
            self.slo_targets = slo_t
        # multi-tenant per-queue overrides (leg masks, replica knobs) —
        # a plain single-tenant actuator has none and the config rules
        overrides = (act.policy_overrides()
                     if hasattr(act, "policy_overrides") else {})
        # an estimate that moved since last tick was measured under the
        # *current* replica count; a frozen one keeps its old basis
        moved = mu != self._last_mu
        self._mu_basis = np.where(moved, replicas, self._mu_basis)
        self._last_mu = mu.copy()

        # -- decide: one fused dispatch for every policy x queue ---------
        impl = "numpy" if self.impl_degraded else self._impl
        try:
            self.state, dec = control_decide(
                self.cfg, self.state, lam=lam, mu=mu, ready=ready,
                replicas=replicas, rep_basis=self._mu_basis, caps=caps,
                cv2=cv2, occupancy=occ, saturated=saturated,
                scalable=scalable, stale=stale, faulty=faulty,
                occ_hi=occ_hi, occ_lo=occ_lo, pressure=pressure,
                slo_target=slo_t, over_frac=over,
                impl=impl, donate=True, device=self.device, **overrides)
        except Exception:
            if impl == "numpy":
                raise                      # host path failing is a bug
            # the "jit" form failed (device error, out of memory, graph
            # capture refused): rebuild the carried state on host and
            # retry the same math on the numpy path this tick; repeated
            # failures degrade the loop to the host path permanently
            self._jit_fail += 1
            self.state = self._state_numpy()
            if (self._jit_fail >= self.jit_fail_limit
                    and not self.impl_degraded):
                self.impl_degraded = True
                self.log.append(ControlRecord(
                    tick=self.ticks, t=time.monotonic(), queue=-1,
                    policy="loop", observed_lam=0.0, observed_mu=0.0,
                    action="impl-degrade", value=self._jit_fail,
                    outcome="applied", error="E_JIT_DISPATCH"))
            self.state, dec = control_decide(
                self.cfg, self.state, lam=lam, mu=mu, ready=ready,
                replicas=replicas, rep_basis=self._mu_basis, caps=caps,
                cv2=cv2, occupancy=occ, saturated=saturated,
                scalable=scalable, stale=stale, faulty=faulty,
                occ_hi=occ_hi, occ_lo=occ_lo, pressure=pressure,
                slo_target=slo_t, over_frac=over,
                impl="numpy", donate=True, **overrides)
        self.ticks += 1
        if self.cfg.slo_enabled:
            # refresh the burn mirrors from the fresh state before the
            # next decision overwrites the buffers it aliases (numpy
            # copies: the exporter's scrape thread must never touch the
            # live leaves)
            self.slo_burn_fast = _host(self.state.burn_fast).astype(
                float)[:q]
            self.slo_burn_slow = _host(self.state.burn_slow).astype(
                float)[:q]
        self._actuate(dec, lam, mu, replicas, caps)
        return dec

    def _quarantine(self, vals, last_good):
        """Sense-side quarantine: substitute the last finite gated
        estimate for any NaN/Inf reading, and fold the (now all-finite)
        values back as the new last-good.  Returns ``(vals, bad)`` with
        ``bad`` the quarantined indices."""
        fin = np.isfinite(vals)
        bad = np.nonzero(~fin)[0]
        if bad.size:
            vals = np.where(fin, vals, last_good)
            self.quarantined += int(bad.size)
        np.copyto(last_good, vals)
        return vals, bad

    def _state_numpy(self) -> ControlState:
        """Rebuild the carried decision state as host numpy arrays.  A
        failed decision on the card may leave the device unreadable; if
        any leaf cannot be read back, restart from the neutral init
        state — confirmation counters and cooldowns re-accumulate within
        a few ticks."""
        try:
            return ControlState(
                *(_host(leaf)[:self.n_queues] for leaf in self.state))
        except Exception:
            return ControlState(*(_host(leaf) for leaf in control_init(
                self.cfg, self.n_queues, device="cpu")))

    def _call_actuator(self, fn, *args):
        """One actuation with retry + backoff under an elapsed budget.

        Returns ``(outcome, error)``: outcome ``'error'`` means the verb
        raised on its final attempt (``E_ACT_RAISE``); a success that
        blew the ``actuation_timeout_s`` budget is annotated
        ``E_ACT_SLOW`` (the action stands, but a consistently slow
        actuator is an operational signal worth auditing)."""
        t0 = time.monotonic()
        delay = self.actuation_backoff_s
        for attempt in range(self.actuation_retries + 1):
            try:
                out = fn(*args)
            except Exception:
                if (attempt < self.actuation_retries
                        and time.monotonic() - t0 < self.actuation_timeout_s):
                    time.sleep(delay)
                    delay = min(delay * 2, self.actuation_timeout_s)
                    continue
                self.actuation_errors += 1
                return "error", "E_ACT_RAISE"
            slow = time.monotonic() - t0 > self.actuation_timeout_s
            return out, ("E_ACT_SLOW" if slow else "")
        return "error", "E_ACT_RAISE"      # pragma: no cover

    def _actuate(self, dec: Decision, lam, mu, replicas, caps) -> None:
        now = time.monotonic()
        act, log = self.actuator, self.log

        def record(i, policy, action, value, outcome, error=""):
            log.append(ControlRecord(
                tick=self.ticks, t=now, queue=int(i), policy=policy,
                observed_lam=float(lam[i]), observed_mu=float(mu[i]),
                action=action, value=int(value), outcome=outcome,
                error=error))

        if self.policies.replica is not None:
            targets = np.asarray(dec.target_replicas)
            for i in np.nonzero(np.asarray(dec.scale_mask))[0]:
                n = int(targets[i])
                if n == int(replicas[i]):
                    continue
                outcome, err = self._call_actuator(act.scale, int(i), n)
                record(i, "replicas", "scale", n, outcome, err)
        if self.policies.buffer is not None:
            targets = np.asarray(dec.target_caps)
            for i in np.nonzero(np.asarray(dec.resize_mask))[0]:
                cap = int(targets[i])
                if cap == int(caps[i]):
                    continue
                outcome, err = self._call_actuator(act.resize, int(i), cap)
                record(i, "capacity", "resize", cap, outcome, err)
        if self.policies.admission is not None:
            shed = np.asarray(dec.shed)
            applied = self._shed.copy()
            for i in np.nonzero(shed != self._shed)[0]:
                outcome, err = self._call_actuator(
                    act.admit, int(i), bool(shed[i]))
                record(i, "admission", "shed" if shed[i] else "admit",
                       int(shed[i]), outcome, err)
                if outcome == "error":
                    # roll back: best-effort restore of the last applied
                    # gate so the loop's memory and the physical gate
                    # cannot diverge — the flip is retried next tick
                    try:
                        act.admit(int(i), bool(self._shed[i]))
                    except Exception:
                        pass
                else:
                    applied[i] = shed[i]
            self._shed = applied
        if self.cfg.slo_enabled:
            # audit burn-rate escalation transitions (observations, not
            # actions — the replica/admission records above carry the
            # actuation; this marks WHY in the decision taxonomy)
            hot = np.asarray(dec.slo_hot)
            for i in np.nonzero(hot != self._slo_hot_prev)[0]:
                record(i, "slo", "burn-hot" if hot[i] else "burn-clear",
                       int(hot[i]), "observed")
            self._slo_hot_prev = hot.copy()

    # -- fleet restructure (multi-tenant attach/detach) --------------------
    def _remap_locked(self, old_index_of_new) -> None:
        """Re-shape every per-queue array the loop carries across ticks
        after the monitored fleet changed.  Caller holds ``_lock`` —
        ``control.group`` invokes this while already holding the tick
        lock so the service restructure and the remap are one atomic
        step from a tick's point of view.  ``old_index_of_new[j]`` is
        the previous queue index of the queue now at position ``j``, or
        -1 for a freshly attached queue (which starts from the neutral
        init state).  Retained queues keep their confirmation counters,
        cooldowns, admission memory, probe timers and measurement
        bases, so tenant churn never resets an unrelated tenant's
        gating state."""
        idx = np.asarray(old_index_of_new, np.int64)
        nq = int(idx.shape[0])
        keep = idx >= 0
        src = idx[keep]

        def take(a, fill, dtype=None):
            a = np.asarray(a)
            out = np.full(nq, fill, dtype or a.dtype)
            if src.size:
                out[keep] = a[src]
            return out

        st = ControlState(*(_host(leaf) for leaf in self.state))
        self.state = ControlState(
            cooldown=take(st.cooldown, 0),
            rep_agree=take(st.rep_agree, 0),
            cap_agree=take(st.cap_agree, 0),
            shedding=take(st.shedding, False),
            peak_mu=take(st.peak_mu, 0.0),
            escalated=take(st.escalated, False),
            probe_timer=take(st.probe_timer, 0),
            burn_fast=take(st.burn_fast, 0.0),
            burn_slow=take(st.burn_slow, 0.0),
            slo_hot=take(st.slo_hot, False))
        self._shed = take(self._shed, False)
        self._mu_basis = take(self._mu_basis, 1)
        self._last_mu = take(self._last_mu, np.nan)
        self._last_blk = take(self._last_blk, 0)
        self._last_tot = take(self._last_tot, 0)
        self._last_good_mu = take(self._last_good_mu, 0.0)
        self._last_good_lam = take(self._last_good_lam, 0.0)
        self.slo_burn_fast = take(self.slo_burn_fast, 0.0)
        self.slo_burn_slow = take(self.slo_burn_slow, 0.0)
        self.slo_targets = take(self.slo_targets, np.nan)
        self._slo_hot_prev = take(self._slo_hot_prev, False)
        self.n_queues = nq

    # -- monitor watchdog --------------------------------------------------
    def watch_monitor(self, get, restart) -> None:
        """Arm the monitor watchdog.  ``get()`` returns the current
        ``FleetMonitorThread``; ``restart()`` builds, starts and
        installs a replacement *on the same service* (which holds every
        estimator's state, so nothing is lost) and returns it.  The
        run() thread polls between ticks; harnesses that ``tick()``
        manually call ``check_monitor()`` themselves."""
        self._mon_get, self._mon_restart = get, restart

    def check_monitor(self) -> bool:
        """One watchdog poll: restart the monitor thread if it died
        (started, no longer alive, never asked to stop).  Returns True
        when a restart fired; the restart is audited as
        ``policy='watchdog'`` with ``E_MONITOR_DEAD``."""
        get, restart = self._mon_get, self._mon_restart
        if get is None or restart is None:
            return False
        try:
            m = get()
        except Exception:
            return False
        if (m is None or m.ident is None or m.is_alive()
                or m._stop_evt.is_set()):
            return False
        restart()
        self.monitor_restarts += 1
        self.log.append(ControlRecord(
            tick=self.ticks, t=time.monotonic(), queue=-1,
            policy="watchdog", observed_lam=0.0, observed_mu=0.0,
            action="monitor-restart", value=self.monitor_restarts,
            outcome="applied", error="E_MONITOR_DEAD"))
        return True

    def health(self) -> dict:
        """Failure-handling counters (all zero on a healthy loop)."""
        return {
            "ticks": self.ticks,
            "tick_errors": self.tick_errors,
            "quarantined": self.quarantined,
            "actuation_errors": self.actuation_errors,
            "monitor_restarts": self.monitor_restarts,
            "jit_failures": self._jit_fail,
            "impl_degraded": self.impl_degraded,
            "control_log_dropped": self.log.dropped_total,
        }

    # -- thread plumbing ---------------------------------------------------
    def run(self) -> None:
        # the current CUDA device is per thread: this thread did not
        # make the service, so it selects the service's card itself
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        try:
            self.warmup()
        except Exception:
            pass        # compile failure falls through to per-tick path
        next_due = time.monotonic()
        while not self._stop_evt.is_set():
            now = time.monotonic()
            if now < next_due:
                self._stop_evt.wait(max(next_due - now, self.min_sleep_s))
                continue
            self.check_monitor()
            try:
                self.tick()
            except Exception:
                # contain: one poisoned tick (actuator bug, service
                # racing a shutdown) must not kill the control thread —
                # count it, audit it, keep ticking
                self.tick_errors += 1
                self.log.append(ControlRecord(
                    tick=self.ticks, t=time.monotonic(), queue=-1,
                    policy="loop", observed_lam=0.0, observed_mu=0.0,
                    action="tick", value=self.tick_errors,
                    outcome="error", error="E_TICK"))
            # re-derive (unless explicit): the monitor thread adapts the
            # shared sampling period live, and the loop must keep its
            # one-decision-per-dispatch cadence relative to the *current*
            # period, not the one frozen at construction
            next_due = now + self._current_period()

    def stop(self) -> None:
        """Stop ticking (idempotent).  In-flight actuation completes —
        the tick lock is never held across ``stop`` itself, so a
        concurrent ``FleetMonitorService.stop()``/``flush()`` cannot
        deadlock against a mid-actuation tick."""
        self._stop_evt.set()
        if self.is_alive():
            self.join(timeout=10)
