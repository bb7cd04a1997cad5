"""Shared math + plain PyTorch versions of the batched monitor kernels.

Three levels:

* ``batched_monitor_ref`` — the per-tick window stage (Eq. 2+3) for
  (Q, w) windows; the plain version of the ``batched_monitor`` kernel.
* ``fleet_window_stage`` / ``fleet_step`` — the *time-batched* form of
  Algorithm 1 over a (Q, T) tile of compacted samples.
  ``monitor_fleet_ref`` drives them as a Python loop over T: the plain
  version of the ``monitor_fleet`` kernel, which computes exactly these
  functions with one thread per queue (``csrc/monitor.cu``).
* ``window_carry`` — the last ``window`` valid samples per queue, the
  window the next tile starts from.

The time-batched window stage applies the Gaussian stencil once per
*sample* instead of once per window position, and each step's mean/std
come from sliding sums built as a static shifted-slice doubling ladder.
The CUDA kernel sums every window in that same ladder order, so kernel
and plain version round alike.

These run on any device and are what the tests compare against the JAX
package; on the CUDA path nothing calls them except to check a kernel.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from repro_torch.core.filters import gaussian_kernel, log_kernel
from repro_torch.core.monitor import _BIG, MonitorConfig, Z_95

__all__ = ["batched_monitor_ref", "monitor_fleet_ref",
           "fleet_static_params", "fleet_window_stage", "fleet_step",
           "fleet_sigma", "carry_of_state", "window_carry",
           "slide_sum_valid", "slide_max_valid"]


def _f32(x: float) -> float:
    """A python float rounded to float32 (what the kernel is given)."""
    return float(np.float32(x))


# The kernel repeats this module's arithmetic operation for operation,
# and the convergence test downstream is exact, so every reduction here
# has a defined order and every division is a true division:
#
# * ``_div`` divides by a 0-dim tensor on the operand's device.  PyTorch
#   turns ``cuda_tensor / python_number`` into a multiplication by the
#   rounded reciprocal, which differs from x / n in the last bit.
# * ``_tree_mean`` sums the last axis as the doubling ladder's balanced
#   tree (``_ladder``), the order the kernel uses, instead of ``mean``,
#   whose order depends on the backend.

def _div(x, n):
    return x / torch.tensor(n, dtype=x.dtype, device=x.device)


def _tree_mean(x):
    n = x.shape[-1]
    return _div(_ladder(x, n, torch.add)[..., 0], n)


def fleet_sigma(count, m2, qhist, *, window_std: bool, cw: int):
    """The fleet paths' sigma(q-bar), one definition for all of them.

    window_std: masked std of the last ``cw`` q-bar folds, gated on
    ``count >= cw`` with the not-ready ``_BIG`` sentinel otherwise.
    Else the Welford stderr sqrt(m2 / count^2) with empty-stats guard
    (matches ``stats.welford_stderr``).
    """
    if window_std:
        muq = _tree_mean(qhist)
        dq = qhist - muq[:, None]
        sig = torch.sqrt(_tree_mean(dq * dq))
        return torch.where(count >= cw, sig, torch.full_like(sig, _BIG))
    safe = torch.where(count > 0, count, 1.0)
    var = torch.where(count > 0, m2 / safe, 0.0)
    return torch.sqrt(torch.clamp(var / safe, min=0.0))


def batched_monitor_ref(windows, *, radius: int = 2, sigma: float = 1.0,
                        z: float = Z_95):
    """windows: (Q, w) -> (q, mu, sd) each (Q,) float32.

    sd is the population std taken in two passes (mean, then the mean
    squared deviation), the form the ``batched_monitor`` kernel uses.
    """
    w = torch.as_tensor(windows).to(torch.float32)
    taps = np.asarray(gaussian_kernel(radius, sigma, normalize=True),
                      np.float32)
    n_out = w.shape[-1] - (2 * radius)
    acc = w[..., 0:n_out] * float(taps[0])
    for i in range(1, 2 * radius + 1):
        acc = acc + w[..., i:i + n_out] * float(taps[i])
    mu = acc.mean(dim=-1)
    dev = acc - mu[..., None]
    sd = torch.sqrt((dev * dev).mean(dim=-1))
    return mu + _f32(z) * sd, mu, sd


# ---------------------------------------------------------------------------
# Static parameters + sliding-window ladders.
# ---------------------------------------------------------------------------

def fleet_static_params(cfg: MonitorConfig) -> types.SimpleNamespace:
    """Bake the config into python scalars for the kernels."""
    g = gaussian_kernel(cfg.gauss_radius, cfg.gauss_sigma,
                        normalize=cfg.gauss_normalize)
    log3 = log_kernel(cfg.log_radius, cfg.log_sigma)
    if len(log3) != 3:
        raise NotImplementedError(
            "fused fleet scan supports log_radius=1 (3-tap LoG) only")
    sl = cfg.sig_trace_len
    return types.SimpleNamespace(
        window=cfg.window,
        gauss_taps=tuple(_f32(t) for t in g),
        gauss_radius=cfg.gauss_radius,
        z=_f32(cfg.quantile_z),
        conv_window=cfg.conv_window,
        log_taps=tuple(_f32(t) for t in log3),
        conv_tol=_f32(cfg.conv_tol),
        rel_tol=cfg.conv_tol_mode == "rel",
        window_std=cfg.sigma_mode == "window_std",
        min_q=float(cfg.min_q_samples),
        # a fresh epoch needs >= gap folds before it can converge
        gap=max(sl, int(cfg.min_q_samples)),
    )


def _ladder(x, n, combine):
    """Valid-mode sliding reduce of width n over the last axis, built as
    a static shifted-slice doubling ladder.  The order of the partial
    sums is part of the contract: the CUDA kernel repeats it."""
    L = x.shape[-1]
    n_out = L - n + 1
    pows = {1: x}
    k = 1
    while k * 2 <= n:
        s = pows[k]
        pows[k * 2] = combine(s[..., :s.shape[-1] - k], s[..., k:])
        k *= 2
    acc = None
    off = 0
    for k in sorted(pows, reverse=True):
        if n & k:
            part = pows[k][..., off:off + n_out]
            acc = part if acc is None else combine(acc, part)
            off += k
    return acc


def slide_sum_valid(x, n):
    return _ladder(x, n, torch.add)


def slide_max_valid(x, n):
    return _ladder(x, n, torch.maximum)


# ---------------------------------------------------------------------------
# Stage A: time-batched window estimates.
# ---------------------------------------------------------------------------

def fleet_window_stage(P, win, comp):
    """Time-batched Eq. 2+3 over a compacted tile.

    win: (B, w) carried window (newest last); comp: (B, T) compacted
    valid samples.  Returns q: (B, T) — the Eq. 3 quantile after each
    compacted sample (garbage until the window is full; callers gate on
    readiness).
    """
    W, r, n = P.window, P.gauss_radius, P.window - 2 * P.gauss_radius
    T = comp.shape[1]
    ext = torch.cat([win, comp], dim=1)                  # (B, W+T)
    L = W + T - 2 * r
    conv = ext[:, :L] * P.gauss_taps[0]
    for i in range(1, 2 * r + 1):
        conv = conv + ext[:, i:i + L] * P.gauss_taps[i]  # (B, L)
    # center first: the windowed sums then cancel at ~machine eps in f32.
    # The centring mean is summed in float64 and rounded once, so its
    # value does not depend on the backend's summation order.
    c = _div(conv.double().sum(dim=1, keepdim=True), L).to(conv.dtype)
    d = conv - c
    s1 = slide_sum_valid(d, n)                           # (B, T+1)
    s2 = slide_sum_valid(d * d, n)
    # step t's window ends at ext col W+t -> sum windows start at t+1
    mu = _div(s1[:, 1:], n)
    var = _div(s2[:, 1:], n) - mu * mu
    sd = torch.sqrt(torch.clamp(var, min=0.0))
    return mu + c + P.z * sd


# ---------------------------------------------------------------------------
# Stage B, sequential form (the kernel's inner loop + plain version).
# ---------------------------------------------------------------------------

def carry_of_state(state) -> tuple:
    """FleetMonitorState -> Stage-B carry tuple (drops win/n_* leaves)."""
    return (state.s_fill, state.count, state.mean, state.m2,
            state.qhist, state.shist, state.rhist,
            state.epoch, state.last_qbar)


def fleet_step(P, carry, q_t, t, m):
    """One Stage-B step: fold one compacted sample's q for every queue.

    All carries are (B,) vectors or chronological (B, k) histories;
    every update is a masked vector op with no data-dependent control
    flow.  Returns (new_carry, outputs) with outputs a 6-tuple of (B,)
    columns in ``MonitorOutput`` order.
    """
    (s_fill, count, mean, m2, qhist, shist, rhist, epoch, last_qbar) = carry
    W, CW = P.window, P.conv_window
    SL = CW + 2

    valid = t < m
    s_fill = torch.clamp(s_fill + valid.to(torch.int32), max=W)
    ready = valid & (s_fill >= W)
    rc = ready[:, None]

    # Welford fold (identical op order to stats.welford_update)
    cnt1 = count + 1.0
    delta = q_t - mean
    mean1 = mean + delta / cnt1
    m21 = m2 + delta * (q_t - mean1)
    count = torch.where(ready, cnt1, count)
    mean = torch.where(ready, mean1, mean)
    m2 = torch.where(ready, m21, m2)
    qbar = mean

    # chronological shift-push (fills are functions of count, see state)
    qhist = torch.where(rc, torch.cat([qhist[:, 1:], qbar[:, None]], dim=1),
                        qhist)
    sig = fleet_sigma(count, m2, qhist, window_std=P.window_std, cw=CW)

    # LoG response over the chronological (t-2, t-1, t) sigma stencil; a
    # response enters the history only once all three taps are post-reset
    l0, l1, l2 = P.log_taps
    resp_new = l0 * shist[:, 0] + l1 * shist[:, 1] + l2 * sig
    push = ready & (count >= 3)
    rhist = torch.where(push[:, None], torch.cat(
        [rhist[:, 1:], resp_new[:, None]], dim=1), rhist)
    shist = torch.where(rc, torch.cat([shist[:, 1:], sig[:, None]], dim=1),
                        shist)

    # convergence test (Eq. 4): count >= SL <=> CW responses post-reset
    resp = rhist.abs().amax(dim=1)
    trace_ready = count >= max(SL, P.min_q)
    tol = torch.full_like(qbar, P.conv_tol)
    if P.rel_tol:
        tol = tol * torch.clamp(qbar.abs(), min=_f32(1e-12))
    conv = ready & trace_ready & torch.isfinite(resp) & (resp < tol)

    # emit + resetStats() (histories need no clearing: every read is
    # gated on count, which only re-arms after a full overwrite)
    last_qbar = torch.where(conv, qbar, last_qbar)
    epoch = epoch + conv.to(torch.int32)
    count = torch.where(conv, 0.0, count)
    mean = torch.where(conv, 0.0, mean)
    m2 = torch.where(conv, 0.0, m2)

    new_carry = (s_fill, count, mean, m2, qhist, shist, rhist,
                 epoch, last_qbar)
    outs = (torch.where(ready, q_t, 0.0), qbar, sig, conv, last_qbar, epoch)
    return new_carry, outs


def monitor_fleet_ref(cfg: MonitorConfig, state, comp, m):
    """Plain PyTorch fused fleet scan over a compacted (Q, T) tile.

    The same stage functions the kernel computes, with the sequential
    Stage B as a Python loop over T.  Returns (new_carry, cols) with cols
    a 6-tuple of (Q, T) output planes.
    """
    P = fleet_static_params(cfg)
    q_seq = fleet_window_stage(P, state.win, comp)
    carry = carry_of_state(state)
    outs = []
    for t in range(comp.shape[1]):
        carry, o = fleet_step(P, carry, q_seq[:, t], t, m)
        outs.append(o)
    return carry, tuple(torch.stack(o, dim=1) for o in zip(*outs))


def window_carry(win, comp, m):
    """The last ``window`` valid samples per queue after a compacted
    tile: row i of ``[win | comp]`` from column ``m[i]`` on."""
    W = win.shape[1]
    ext = torch.cat([win, comp], dim=1)                  # (Q, W+T)
    idx = m.to(torch.int64)[:, None] + torch.arange(W, device=win.device)
    return torch.gather(ext, 1, idx)
