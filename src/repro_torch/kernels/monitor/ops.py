"""Public ops: fleet-scale batched monitor.

``fleet_monitor_scan`` is the throughput path: it consumes a (Q, T) tile
of raw (tc, blocked) samples per dispatch, discards blocked samples by
stream compaction, runs the fused Algorithm-1 scan (Stage A window
estimates + Stage B convergence fold: the ``monitor_fleet`` CUDA kernel,
or on the host the segmented ``rounds`` form), and scatters the per-valid-step outputs back onto the original timeline
so the result is step-for-step identical to ``run_monitor``.

``fleet_monitor_q`` / ``fleet_monitor_step`` are the one-tick forms for
callers that hand-maintain windows (the ``batched_monitor`` kernel);
``fleet_monitor_step`` honors ``MonitorConfig.sigma_mode`` so fleet and
single-queue paths converge identically.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.monitor import (_BIG, FleetMonitorState, MonitorConfig,
                                      MonitorOutput, _time_major)
from repro_torch.core.stats import Welford, welford_stderr, welford_update
from repro_torch.kernels.monitor.kernel import batched_monitor, monitor_fleet
from repro_torch.kernels.monitor.ref import (batched_monitor_ref,
                                             carry_of_state, fleet_sigma,
                                             monitor_fleet_ref, window_carry)
from repro_torch.kernels.monitor.rounds import monitor_fleet_rounds

__all__ = ["fleet_monitor_q", "fleet_monitor_step", "fleet_monitor_scan",
           "FleetStepState", "fleet_step_init", "batched_monitor_ref"]

# ---------------------------------------------------------------------------
# Fused (Q, T) scan.
# ---------------------------------------------------------------------------

def _carry_to_state(carry, win, n_total, n_blocked) -> FleetMonitorState:
    (s_fill, count, mean, m2, qhist, shist, rhist, epoch, last_qbar) = carry
    return FleetMonitorState(
        win=win, s_fill=s_fill, count=count, mean=mean, m2=m2,
        qhist=qhist, shist=shist, rhist=rhist,
        epoch=epoch, last_qbar=last_qbar,
        n_total=n_total, n_blocked=n_blocked)


def _entry_sigma(cfg: MonitorConfig, state: FleetMonitorState):
    """sigma(q-bar) implied by the carried state (pre-tile value)."""
    return fleet_sigma(state.count, state.m2, state.qhist,
                       window_std=cfg.sigma_mode == "window_std",
                       cw=cfg.conv_window)


def _compact(tc, blocked):
    """Stream compaction: drop blocked samples, keep time order.

    Returns (comp, m, cnt): compacted samples, the per-queue valid counts,
    and the per-step running valid count used to map results back, each
    (Q, T) plane in the layout of ``tc``.  Row-major: comp has unit
    column stride and row stride T + 1 (the scatter's dump column is cut
    off by a view).  Time-major (``tc`` the ``.T`` of a contiguous (T, Q)
    tensor): the same scatter runs along the time axis of a (T + 1, Q)
    buffer, and comp is the ``.T`` of its first T rows.
    """
    Q, T = tc.shape
    if blocked is None:
        cnt = torch.arange(1, T + 1, dtype=torch.int32,
                           device=tc.device).expand(Q, T)
        return tc, torch.full((Q,), T, dtype=torch.int32,
                              device=tc.device), cnt
    if _time_major(tc):        # on the (T, Q) tensors, time along dim 0
        x, valid, dim = tc.T, ~blocked.T, 0
    else:
        x, valid, dim = tc, ~blocked, 1
    cnt = torch.cumsum(valid.to(torch.int32), dim=dim, dtype=torch.int32)
    m = cnt.select(dim, T - 1).contiguous()
    dest = torch.where(valid, cnt - 1, T).to(torch.int64)   # T = dump slot
    comp = torch.zeros(x.shape[:dim] + (T + 1,) + x.shape[dim + 1:],
                       dtype=tc.dtype, device=tc.device)
    comp.scatter_(dim, dest, x)
    comp = comp.narrow(dim, 0, T)
    return (comp.T, m, cnt.T) if dim == 0 else (comp, m, cnt)


def _fleet_monitor_scan_impl(cfg: MonitorConfig, state: FleetMonitorState,
                             tc, blocked=None, *, impl: str = "cuda",
                             mode: str = "full", interpret: bool = True,
                             block_q: int = 256, sub_t: int = 32,
                             donate: bool = False):
    """One fused dispatch over a (Q, T) tile.

    impl: "cuda" (the fused kernel; its plain version stands in only for
    CPU tensors), "rounds" (the segmented time-batched form, the host
    fast path; ``sub_t`` steps a sub-tile, at most the convergence gap)
    or "scan" (the plain sequential version on any device).
    mode="full" returns a MonitorOutput with (Q, T) leaves matching
    ``monitor_update`` step for step; mode="state" skips per-step outputs
    and returns (new_state, None).  ``tc`` and ``blocked`` may be
    row-major or the time-major ``.T`` of (T, Q) tensors; the kernel
    reads either.  With ``donate`` the kernel updates ``state``'s tensors
    in place; otherwise they are copied first and the caller's state is
    left as it was.  ``interpret`` and ``block_q`` are accepted for the
    JAX signature: there is nothing to interpret on the card, and the
    kernel's thread blocks do not depend on ``block_q``.
    """
    del interpret, block_q
    tc = tc.to(torch.float32)
    Q, T = tc.shape
    comp, m, cnt = _compact(tc, blocked)

    # --- fused scan over the compacted tile -----------------------------
    full = mode == "full"
    if full and blocked is not None:
        # the pre-tile values blocked leading steps replay (taken before
        # the kernel updates the state in place)
        entry = (state.mean.clone(), _entry_sigma(cfg, state),
                 state.last_qbar.clone(), state.epoch.clone())
    if impl == "cuda":
        if not donate:
            state = FleetMonitorState(*(a.clone() for a in state))
        cols = monitor_fleet(cfg, state, comp, m, full=full)
        carry, win = carry_of_state(state), state.win
    elif impl == "scan":
        carry, cols = monitor_fleet_ref(cfg, state, comp, m)
        win = window_carry(state.win, comp, m)
    elif impl == "rounds":
        carry, cols = monitor_fleet_rounds(cfg, state, comp, m, mode=mode,
                                           sub_t=sub_t)
        carry, win = carry[:9], carry[9]   # rounds carries the window
    else:
        raise ValueError(f"unknown impl {impl!r}")

    n_total = state.n_total + T
    n_blocked = state.n_blocked + (
        0 if blocked is None
        else blocked.sum(dim=1, dtype=torch.int32))
    new_state = _carry_to_state(carry, win, n_total, n_blocked)

    if not full:
        return new_state, None
    (q_c, qbar_c, sig_c, conv_c, est_c, ep_c) = cols

    if blocked is None:    # compact timeline == original timeline
        return new_state, MonitorOutput(
            q=q_c, qbar=qbar_c, sigma_qbar=sig_c,
            converged=conv_c.to(torch.bool), estimate=est_c, epoch=ep_c)

    # --- scatter back onto the original (possibly blocked) timeline ----
    valid = ~blocked
    g_idx = torch.clamp(cnt - 1, 0, T - 1).to(torch.int64)

    def gat(a):
        return torch.gather(a, 1, g_idx)

    has = cnt >= 1

    def hold(a, e):
        return torch.where(has, gat(a), e[:, None])

    # a blocked step after a converged step must replay the *post-reset*
    # statistics (monitor_update recomputes them from the reset state):
    # q-bar resets to 0, sigma to the not-ready sentinel (window_std) or
    # the empty-stats stderr of 0
    g_conv = gat(conv_c.to(torch.bool))
    sig_reset = _BIG if cfg.sigma_mode == "window_std" else 0.0

    def post(a, r):
        return torch.where(g_conv, r, gat(a))

    mean0, sig0, last0, epoch0 = entry
    out = MonitorOutput(
        q=torch.where(valid, gat(q_c), 0.0),
        qbar=torch.where(
            valid, gat(qbar_c),
            torch.where(has, post(qbar_c, 0.0), mean0[:, None])),
        sigma_qbar=torch.where(
            valid, gat(sig_c),
            torch.where(has, post(sig_c, sig_reset), sig0[:, None])),
        converged=valid & g_conv,
        estimate=hold(est_c, last0),
        epoch=hold(ep_c, epoch0),
    )
    return new_state, out


# The public form (the JAX package jits it; PyTorch runs it eagerly).
fleet_monitor_scan = _fleet_monitor_scan_impl


# ---------------------------------------------------------------------------
# One-tick forms.
# ---------------------------------------------------------------------------

def fleet_monitor_q(windows, *, use_pallas: bool = True,
                    interpret: bool = True, block_q: int = 256):
    """(Q, w) windows -> (Q,) Eq.3 quantile estimates.

    ``use_pallas`` (the JAX package's name) selects the ``batched_monitor``
    CUDA kernel, else its plain version; ``interpret`` and ``block_q`` are
    accepted for the JAX signature and do not change the result."""
    del interpret, block_q
    if use_pallas:
        q, _, _ = batched_monitor(windows)
        return q
    q, _, _ = batched_monitor_ref(windows)
    return q


class FleetStepState(NamedTuple):
    """Per-tick fleet stats state: vector Welford + the q-bar ring that
    ``sigma_mode='window_std'`` needs (leaves shaped (Q,) / (Q, cw))."""
    welford: Welford
    qbar_ring: torch.Tensor
    qbar_head: torch.Tensor
    qbar_fill: torch.Tensor


def fleet_step_init(cfg: MonitorConfig, n_queues: int,
                    dtype=torch.float32, device="cuda") -> FleetStepState:
    z = torch.zeros((n_queues,), dtype=dtype, device=device)
    return FleetStepState(
        welford=Welford(count=z, mean=z, m2=z),
        qbar_ring=torch.zeros((n_queues, cfg.conv_window), dtype=dtype,
                              device=device),
        qbar_head=torch.zeros((n_queues,), dtype=torch.int32, device=device),
        qbar_fill=torch.zeros((n_queues,), dtype=torch.int32, device=device))


def fleet_monitor_step(windows, state, *, cfg: Optional[MonitorConfig] = None,
                       use_pallas: bool = True, interpret: bool = True):
    """One fleet monitoring tick: (Q, w) windows + per-queue stats state
    -> ``(q, new_state, sigma_qbar)``.

    ``state`` may be a :class:`FleetStepState` or a bare vector
    :class:`Welford` (legacy form; implies ``sigma_mode='stderr'`` since
    a Welford state alone cannot express the window-std trajectory).
    sigma(q-bar) follows ``cfg.sigma_mode`` — the same statistic the
    single-queue ``monitor_update`` uses.  ``use_pallas`` and
    ``interpret`` are as in :func:`fleet_monitor_q`.
    """
    cfg = cfg or MonitorConfig()
    q = fleet_monitor_q(windows, use_pallas=use_pallas, interpret=interpret)
    bare = isinstance(state, Welford)
    wf = state if bare else state.welford
    new_wf = welford_update(wf, q)
    if bare:
        return q, new_wf, welford_stderr(new_wf)

    if cfg.sigma_mode == "stderr":
        sigma = welford_stderr(new_wf)
        new_state = state._replace(welford=new_wf)
        return q, new_state, sigma

    cw = state.qbar_ring.shape[1]
    qbar = new_wf.mean
    lane = torch.arange(cw, device=qbar.device)[None, :]
    ring = torch.where(lane == state.qbar_head[:, None], qbar[:, None],
                       state.qbar_ring)
    head = torch.remainder(state.qbar_head + 1, cw)
    fill = torch.clamp(state.qbar_fill + 1, max=cw)
    sigma = fleet_sigma(fill, new_wf.m2, ring, window_std=True, cw=cw)
    new_state = FleetStepState(welford=new_wf, qbar_ring=ring,
                               qbar_head=head, qbar_fill=fill)
    return q, new_state, sigma
