"""Segmented time-batched fleet scan — the host-side fast path.

The port of the JAX package's ``kernels/monitor/rounds.py``.  The
sequential Stage B of ``ref.py`` pays a handful of small ops per sample;
on the CPU that per-op floor dominates.  This form removes the
per-sample loop by a structural property of Algorithm 1: after
``resetStats()`` a fresh epoch needs at least ``gap = max(sig_trace_len,
min_q_samples)`` folds before it can converge again, so a sub-tile of
``sub_t <= gap`` steps holds at most one convergence per queue — a
statically bounded number of segment evaluations with no data-dependent
control flow.

Dispatch-scope precompute: the time-batched window stage, the
fold-readiness mask, and prefix sums of the centered q stream.  Each
sub-tile then runs one *detection* evaluation — q-bar in closed form
from the prefix sums, sigma(q-bar) from a width-cw sliding ladder over
the q-bar timeline, the LoG trace from shifted slices, the Eq. 4
response from a sliding-max ladder, first convergence by argmax — and
one *carry* evaluation that rebuilds the post-reset tail statistics and
harvests the chronological histories the next sub-tile needs.  The
histories are the ``FleetMonitorState`` buffers every form shares.

The prefix sums keep the JAX package's doubling ladder (not
``torch.cumsum``), so they add in its order; its clipped
``take_along_axis`` becomes ``torch.gather`` with a clamp.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.monitor import _BIG, MonitorConfig
from repro_torch.kernels.monitor.ref import (_div, fleet_static_params,
                                             fleet_window_stage,
                                             slide_max_valid,
                                             slide_sum_valid)

__all__ = ["monitor_fleet_rounds"]


def _prefix(x):
    """Inclusive prefix sums via a doubling ladder, with a leading zero
    column: returns (Q, L+1) with out[:, j] = sum(x[:, :j])."""
    L = x.shape[1]
    k = 1
    while k < L:
        x = x + F.pad(x, (k, 0))[:, :L]
        k *= 2
    return F.pad(x, (1, 0))


def _take(x, idx):
    return torch.gather(x, 1, torch.clamp(idx, 0, x.shape[1] - 1).long())


def monitor_fleet_rounds(cfg: MonitorConfig, state, comp, m, *,
                         mode: str = "full", sub_t: int = 32):
    """Run the segmented fleet scan over a compacted (Q, T) tile.

    comp: (Q, T) compacted valid samples, m: (Q,) valid counts.  Returns
    ``(carry, outs)``: carry is the 9-leaf Stage-B tuple plus the window
    carry appended (10 leaves); outs is a 6-tuple of (Q, T) compact-time
    output planes, or None when mode != "full".
    """
    P = fleet_static_params(cfg)
    Q, T = comp.shape
    W, CW = P.window, P.conv_window
    gap = P.gap
    l0, l1, l2 = P.log_taps
    f32 = comp.dtype
    dev = comp.device
    big = torch.tensor(_BIG, dtype=f32, device=dev)
    cw_t = torch.arange(CW, device=dev)[None, :]

    count, mean, m2 = state.count, state.mean, state.m2
    qhist, shist, rhist = state.qhist, state.shist, state.rhist
    epoch, last = state.epoch, state.last_qbar

    # ---- dispatch-scope precompute (tiling-invariant) ----
    q = fleet_window_stage(P, state.win, comp)               # (Q, T)
    mc_g = m[:, None]
    F0 = torch.clamp(W - 1 - state.s_fill, min=0)[:, None]   # first fold
    tt_g = torch.arange(T, device=dev)[None, :]
    ready_g = (tt_g < mc_g) & (tt_g >= F0)
    nready = torch.clamp(ready_g.sum(1, keepdim=True), min=1)
    cq = torch.where(ready_g, q, 0.0).sum(1, keepdim=True) / nready
    dq = torch.where(ready_g, q - cq, 0.0)
    ps1 = _prefix(dq)                                        # (Q, T+1)
    ps2 = _prefix(dq * dq)

    a = torch.zeros((Q,), dtype=torch.int32, device=dev)  # segment start
    out_cols = [] if mode == "full" else None

    def segment_planes(c0, L, A, count, mean):
        """Closed-form per-step statistics of the current segments over
        tile cols [c0, c0+L): q-bar, sigma timeline pieces, LoG trace."""
        tt = tt_g[:, c0:c0 + L]
        k = torch.clamp(tt - A + 1, 0, T).to(f32)
        have = k > 0
        cnt = count[:, None] + k
        csafe = torch.clamp(cnt, min=1.0)
        S1 = ps1[:, c0 + 1:c0 + L + 1] - _take(ps1, A)
        qbar = torch.where(
            have, mean[:, None] + (S1 + k * (cq - mean[:, None])) / csafe,
            mean[:, None])
        tl = torch.cat([qhist, qbar], dim=1)                 # (Q, CW+L)
        if P.window_std:
            Dt = tl - cq
            s1w = slide_sum_valid(Dt, CW)                    # (Q, L+1)
            s2w = slide_sum_valid(Dt * Dt, CW)
            muw = _div(s1w, CW)
            stdw = torch.sqrt(torch.clamp(_div(s2w, CW) - muw * muw,
                                          min=0.0))
            sig_in = torch.where(cnt >= CW, stdw[:, 1:], big)
            e0 = torch.where(count >= CW, stdw[:, 0], big)
        else:
            S2 = ps2[:, c0 + 1:c0 + L + 1] - _take(ps2, A)
            ksafe = torch.clamp(k, min=1.0)
            mb = S1 / ksafe + cq
            m2b = torch.clamp(S2 - (S1 * S1) / ksafe, min=0.0)
            dlt = mb - mean[:, None]
            m2t = torch.where(have, m2[:, None] + m2b
                              + dlt * dlt * count[:, None] * k / csafe,
                              m2[:, None])
            s0 = torch.where(count > 0, count, 1.0)
            e0 = torch.sqrt(torch.clamp(
                torch.where(count > 0, m2 / s0, 0.0) / s0, min=0.0))
            sig_in = torch.where(
                have, torch.sqrt(torch.clamp(m2t / csafe / csafe, min=0.0)),
                e0[:, None])
        stl = torch.cat([shist, sig_in], dim=1)              # (Q, 2+L)
        log_in = (l0 * stl[:, :L] + l1 * stl[:, 1:L + 1]
                  + l2 * stl[:, 2:])
        ltl = torch.cat([rhist, log_in], dim=1)              # (Q, CW+L)
        return tt, k, have, cnt, qbar, tl, stl, ltl, sig_in, e0

    for c0 in range(0, T, sub_t):
        L = min(sub_t, T - c0)
        m_l = torch.clamp(m - c0, 0, L)[:, None]
        n_detect = 1 + (L - 1) // gap    # 1 for any sub_t <= gap

        for e in range(n_detect):
            A = torch.maximum(a[:, None], F0)
            (tt, k, have, cnt, qbar, tl, stl, ltl, sig_in, e0) = \
                segment_planes(c0, L, A, count, mean)
            resp_in = slide_max_valid(ltl.abs(), CW)[:, 1:]
            tol = torch.full_like(qbar, P.conv_tol)
            if P.rel_tol:
                tol = tol * torch.clamp(qbar.abs(), min=1e-12)
            convp = (have & (tt < mc_g) & (cnt >= float(gap))
                     & torch.isfinite(resp_in) & (resp_in < tol))
            exists = convp.any(1)
            # argmax returns the first maximal index: the first step
            j1 = convp.to(torch.uint8).argmax(1) + c0        # global col
            t1 = torch.where(exists, j1, T)
            qlast = _take(qbar, (t1 - c0)[:, None])[:, 0]

            if mode == "full":
                span = (tt >= torch.clamp(a[:, None] - c0, min=0) + c0) \
                    & (tt <= torch.clamp(t1, max=c0 + L - 1)[:, None])
                at1 = (tt == t1[:, None]) & exists[:, None]
                sig_step = torch.where(have, sig_in, e0[:, None])
                ep_span = epoch[:, None] + at1.to(torch.int32)
                es_span = torch.where(at1, qlast[:, None], last[:, None])
                if e == 0:
                    oq = torch.where(span, qbar, 0.0)
                    osg = torch.where(span, sig_step, 0.0)
                    ocv = at1 & span
                    oes = torch.where(span, es_span, 0.0)
                    oep = torch.where(span, ep_span, 0)
                else:
                    oq = torch.where(span, qbar, oq)
                    osg = torch.where(span, sig_step, osg)
                    ocv = ocv | (at1 & span)
                    oes = torch.where(span, es_span, oes)
                    oep = torch.where(span, ep_span, oep)

            zf = torch.zeros_like(count)
            a = torch.where(exists, (t1 + 1).to(torch.int32), a)
            count = torch.where(exists, zf, count)
            mean = torch.where(exists, zf, mean)
            m2 = torch.where(exists, zf, m2)
            epoch = epoch + exists.to(torch.int32)
            last = torch.where(exists, qlast, last)

        # ---- carry evaluation: no detection (the gap bound rules out a
        # further convergence in this tile); rebuilds the post-reset tail
        # and harvests the chronological histories ----
        A = torch.maximum(a[:, None], F0)
        (tt, k, have, cnt, qbar, tl, stl, ltl, sig_in, e0) = \
            segment_planes(c0, L, A, count, mean)
        if mode == "full":
            span = tt >= a[:, None]
            sig_step = torch.where(have, sig_in, e0[:, None])
            oq = torch.where(span, qbar, oq)
            osg = torch.where(span, sig_step, osg)
            oes = torch.where(span, last[:, None], oes)
            oep = torch.where(span, epoch[:, None], oep)
            out_cols.append((torch.where(ready_g[:, c0:c0 + L],
                                         q[:, c0:c0 + L], 0.0),
                             oq, osg, ocv, oes, oep))

        # Welford carry: absorb this tile's folds of the live segment
        # [A, absorb_end) into (count, mean, m2) — closed form + Chan
        absorb = torch.clamp(mc_g, max=c0 + L)               # (Q, 1)
        kend = torch.clamp(absorb - A, 0, T).to(f32)
        havek = kend[:, 0] > 0
        cntk = torch.clamp(count[:, None] + kend, min=1.0)
        S1e = _take(ps1, absorb) - _take(ps1, A)
        S2e = _take(ps2, absorb) - _take(ps2, A)
        ke = torch.clamp(kend, min=1.0)
        mbe = S1e / ke + cq
        m2be = torch.clamp(S2e - S1e * S1e / ke, min=0.0)
        de = mbe - mean[:, None]
        meanF = torch.where(
            havek,
            (mean[:, None] + (S1e + kend * (cq - mean[:, None])) / cntk)[:, 0],
            mean)
        m2F = torch.where(
            havek, (m2[:, None] + m2be + de * de * count[:, None] * kend
                    / cntk)[:, 0], m2)
        count, mean, m2 = count + kend[:, 0], meanF, m2F
        # the absorbed folds must not be re-counted by the next tile
        a = torch.maximum(a, absorb[:, 0].to(torch.int32))

        qhist = _take(tl, m_l + cw_t)
        shist = _take(stl, m_l + torch.arange(2, device=dev)[None, :])
        rhist = _take(ltl, m_l + cw_t)

    # ---- dispatch-level carries ----
    ext = torch.cat([state.win, comp], dim=1)
    win = _take(ext, m[:, None] + torch.arange(W, device=dev)[None, :])
    s_fill = torch.clamp(state.s_fill + m, max=W)

    carry = (s_fill, count, mean, m2, qhist, shist, rhist, epoch, last,
             win)
    if mode != "full":
        return carry, None
    outs = tuple(torch.cat(parts, dim=1) for parts in zip(*out_cols))
    return carry, outs
