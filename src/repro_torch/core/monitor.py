"""Online non-blocking service-rate monitor — the paper's Algorithm 1.

Pipeline (paper §IV):

  tc sample --[discard blocked states]--> sliding window S (size w)
     --[Gaussian filter r=2, Eq.2, valid mode]--> S'
     --[q = mean(S') + 1.64485 * std(S'), Eq.3]--> q stream
     --[Welford running mean]--> q-bar, sigma(q-bar)
     --[LoG filter r=1 sigma=.5, Eq.4 over sigma trace; max|.| < tol]-->
        converged -> emit q-bar, resetStats(), next epoch

Three implementations, same math:

* ``MonitorState`` + ``monitor_update`` — a torch state machine whose
  leaves may carry any leading batch shape (a (Q,) batch is a fleet of
  independent queues; ``run_monitor`` drives it over a time axis).
* ``FleetMonitorState`` + ``run_monitor_fleet`` — the time-batched fleet
  estimator: one fused CUDA kernel launch per ``chunk_t`` samples
  (``repro_torch.kernels.monitor``).
* ``HostMonitor`` — float64 numpy object used by the real host-side monitor
  threads in ``repro_torch.streams`` (the paper's per-queue monitor thread).

Rates are maintained in *items per period*; callers convert with
``rate = q_bar * d_bytes / T_seconds`` exactly as in the paper.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import filters
from repro_torch.core.device import resolve_device
from repro_torch.core.stats import (Welford, welford_init, welford_update,
                                    welford_stderr)

__all__ = [
    "MonitorConfig",
    "MonitorState",
    "MonitorOutput",
    "monitor_init",
    "monitor_update",
    "run_monitor",
    "FleetMonitorState",
    "fleet_monitor_init",
    "run_monitor_fleet",
    "fleet_rate_readout",
    "fleet_dispatch_trace_count",
    "HostMonitor",
    "SamplingPeriodController",
    "gated_rate_arrays",
    "fleet_state_from_numpy",
    "fleet_state_to_numpy",
    "resolve_device",
]

Z_95 = 1.64485  # Eq. 3: standard-normal 95th-percentile multiplier.
_BIG = 1e30     # finite "not ready" sentinel (inf would NaN through the LoG)


@dataclasses.dataclass(frozen=True)
class MonitorConfig:
    """Tuning knobs; defaults follow the paper where given."""
    window: int = 32                 # w — sliding window of tc samples
    gauss_radius: int = 2            # paper: radius 2 ("best balance")
    gauss_sigma: float = 1.0
    gauss_normalize: bool = True     # False = verbatim Eq. 2 (sum ~ .9913)
    quantile_z: float = Z_95
    conv_window: int = 16            # paper: w <- 16 for convergence
    log_radius: int = 1              # paper: radius 1
    log_sigma: float = 0.5           # paper: sigma = 1/2
    conv_tol: float = 1e-3           # tolerance on filtered sigma trace
    conv_tol_mode: str = "rel"       # "rel": tol * |q-bar|; "abs": paper's 5e-7
    sigma_mode: str = "window_std"   # "window_std" | "stderr"
    min_q_samples: int = 32          # q obs required before testing conv.

    @classmethod
    def paper_faithful(cls) -> "MonitorConfig":
        """The constants exactly as printed in the paper (abs 5e-7)."""
        return cls(conv_tol=5e-7, conv_tol_mode="abs", gauss_normalize=False)

    @property
    def sig_trace_len(self) -> int:
        return self.conv_window + 2 * self.log_radius

    def __post_init__(self):
        if self.window <= 2 * self.gauss_radius:
            raise ValueError("window must exceed 2*gauss_radius")
        if self.conv_tol_mode not in ("rel", "abs"):
            raise ValueError(f"bad conv_tol_mode {self.conv_tol_mode}")
        if self.sigma_mode not in ("window_std", "stderr"):
            raise ValueError(f"bad sigma_mode {self.sigma_mode}")


class MonitorState(NamedTuple):
    """Per-queue Algorithm-1 state.  All buffers are *index-based circular
    buffers* (write head advances mod length) — a push is a masked O(1)
    write instead of a shift-everything copy.  Leaves may carry a leading
    batch shape (B,): each batch row is an independent queue."""
    s_buf: torch.Tensor      # (..., window) circular tc window S
    s_head: torch.Tensor     # int32, next write slot == oldest entry
    s_fill: torch.Tensor     # int32, valid entries in s_buf (saturating)
    q_stats: Welford         # running stats of q -> q-bar
    qbar_buf: torch.Tensor   # (..., conv_window) circular recent q-bar
    qbar_head: torch.Tensor
    qbar_fill: torch.Tensor
    sig_buf: torch.Tensor    # (..., sig_trace_len) circular sigma trace
    sig_head: torch.Tensor
    sig_fill: torch.Tensor
    epoch: torch.Tensor      # int32, completed convergences
    last_qbar: torch.Tensor  # last converged estimate (items/period)
    n_total: torch.Tensor    # int32 diagnostics
    n_blocked: torch.Tensor


class MonitorOutput(NamedTuple):
    q: torch.Tensor          # this step's Eq.3 quantile (0 until window full)
    qbar: torch.Tensor       # running mean of q
    sigma_qbar: torch.Tensor  # stability statistic
    converged: torch.Tensor  # bool — emitted this step
    estimate: torch.Tensor   # last converged q-bar (items/period)
    epoch: torch.Tensor


def monitor_init(cfg: MonitorConfig, dtype=torch.float32, batch=(),
                 device="cuda") -> MonitorState:
    batch = tuple(batch)
    device = resolve_device(device)

    def i0():
        return torch.zeros(batch, dtype=torch.int32, device=device)

    def f(*n):
        return torch.zeros(batch + n, dtype=dtype, device=device)

    return MonitorState(
        s_buf=f(cfg.window), s_head=i0(), s_fill=i0(),
        q_stats=welford_init(dtype, batch, device),
        qbar_buf=f(cfg.conv_window), qbar_head=i0(), qbar_fill=i0(),
        sig_buf=f(cfg.sig_trace_len), sig_head=i0(), sig_fill=i0(),
        epoch=i0(), last_qbar=f(), n_total=i0(), n_blocked=i0())


def _ring_push(buf, head, x, do_push):
    """Masked write of x at the head slot iff do_push; head advances mod n."""
    n = buf.shape[-1]
    lane = torch.arange(n, device=buf.device)
    hit = (lane == head[..., None]) & do_push[..., None]
    new = torch.where(hit, x[..., None].to(buf.dtype), buf)
    new_head = torch.where(do_push, torch.remainder(head + 1, n), head)
    return new, new_head


def _ring_conv(buf, head, taps):
    """Valid-mode correlation of a circular buffer with a static kernel.

    Returns ``(conv, valid)``: the circular correlation (length n, as
    shifted-slice MACs) and the mask of the n-2r windows that do not
    straddle the seam between newest and oldest entry — exactly the
    valid-mode outputs of the chronological window, in rotated order.
    All downstream reductions (mean/std/max|.|) are order-free.
    """
    n = buf.shape[-1]
    r = (len(taps) - 1) // 2
    ext = torch.cat([buf, buf[..., :2 * r]], dim=-1)
    conv = ext[..., :n] * float(np.float32(taps[0]))
    for i in range(1, 2 * r + 1):
        conv = conv + ext[..., i:i + n] * float(np.float32(taps[i]))
    lane = torch.arange(n, device=buf.device)
    valid = torch.remainder(lane - head[..., None], n) < n - 2 * r
    return conv, valid


def _where_tree(cond, new, old):
    return type(new)(*(torch.where(cond, a, b) for a, b in zip(new, old)))


def monitor_update(cfg: MonitorConfig, state: MonitorState, tc, blocked
                   ) -> tuple[MonitorState, MonitorOutput]:
    """One sampling period: ingest (tc, blocked), advance Algorithm 1."""
    dtype = state.s_buf.dtype
    dev = state.s_buf.device
    tc = torch.as_tensor(tc, dtype=dtype, device=dev)
    blocked = torch.as_tensor(blocked, dtype=torch.bool, device=dev)
    valid = ~blocked

    n_total = state.n_total + 1
    n_blocked = state.n_blocked + blocked.to(torch.int32)

    # --- window stage -----------------------------------------------------
    s_buf, s_head = _ring_push(state.s_buf, state.s_head, tc, valid)
    s_fill = torch.clamp(state.s_fill + valid.to(torch.int32),
                         max=cfg.window)
    window_ready = valid & (s_fill >= cfg.window)

    g_taps = filters.gaussian_taps(cfg.gauss_radius, float(cfg.gauss_sigma),
                                   cfg.gauss_normalize)
    conv, conv_ok = _ring_conv(s_buf, s_head, g_taps)
    n_out = cfg.window - 2 * cfg.gauss_radius
    mu_sp = torch.where(conv_ok, conv, 0.0).sum(dim=-1) / n_out
    dev_sp = torch.where(conv_ok, conv - mu_sp[..., None], 0.0)
    sd_sp = torch.sqrt(torch.clamp((dev_sp * dev_sp).sum(dim=-1) / n_out,
                                   min=0.0))
    q = mu_sp + float(np.float32(cfg.quantile_z)) * sd_sp   # Eq. 3

    # --- q-bar stage (Welford) --------------------------------------------
    q_stats = _where_tree(window_ready,
                          welford_update(state.q_stats, q), state.q_stats)
    qbar = q_stats.mean

    qbar_buf, qbar_head = _ring_push(state.qbar_buf, state.qbar_head,
                                     qbar, window_ready)
    qbar_fill = torch.clamp(state.qbar_fill + window_ready.to(torch.int32),
                            max=cfg.conv_window)

    if cfg.sigma_mode == "stderr":
        sigma_qbar = welford_stderr(q_stats)
    else:  # std of the recent q-bar trajectory — its decay *is* stability
        have = qbar_fill >= cfg.conv_window
        mu_b = qbar_buf.mean(dim=-1, keepdim=True)
        dq = qbar_buf - mu_b
        std = torch.sqrt((dq * dq).mean(dim=-1))
        sigma_qbar = torch.where(have, std,
                                 torch.full_like(std, _BIG))

    sig_buf, sig_head = _ring_push(state.sig_buf, state.sig_head,
                                   sigma_qbar, window_ready)
    sig_fill = torch.clamp(state.sig_fill + window_ready.to(torch.int32),
                           max=cfg.sig_trace_len)

    # --- convergence stage (Eq. 4) ----------------------------------------
    l_taps = filters.log_taps(cfg.log_radius, float(cfg.log_sigma))
    filt, filt_ok = _ring_conv(sig_buf, sig_head, l_taps)
    resp = torch.where(filt_ok, filt.abs(), 0.0).amax(dim=-1)
    tol = torch.full_like(qbar, cfg.conv_tol)
    if cfg.conv_tol_mode == "rel":
        tol = tol * torch.clamp(qbar.abs(), min=float(np.float32(1e-12)))
    trace_ready = (sig_fill >= cfg.sig_trace_len) \
        & (q_stats.count >= cfg.min_q_samples)
    converged = window_ready & trace_ready & torch.isfinite(resp) \
        & (resp < tol)

    # --- emit + resetStats() ----------------------------------------------
    last_qbar = torch.where(converged, qbar, state.last_qbar)
    epoch = state.epoch + converged.to(torch.int32)
    zero_f = torch.zeros_like(qbar)
    zero_i = torch.zeros_like(qbar_head)
    c = converged[..., None]
    q_stats = _where_tree(converged, Welford(zero_f, zero_f, zero_f),
                          q_stats)
    qbar_buf = torch.where(c, 0.0, qbar_buf)
    qbar_head = torch.where(converged, zero_i, qbar_head)
    qbar_fill = torch.where(converged, zero_i, qbar_fill)
    sig_buf = torch.where(c, 0.0, sig_buf)
    sig_head = torch.where(converged, zero_i, sig_head)
    sig_fill = torch.where(converged, zero_i, sig_fill)

    new_state = MonitorState(
        s_buf=s_buf, s_head=s_head, s_fill=s_fill, q_stats=q_stats,
        qbar_buf=qbar_buf, qbar_head=qbar_head, qbar_fill=qbar_fill,
        sig_buf=sig_buf, sig_head=sig_head, sig_fill=sig_fill,
        epoch=epoch, last_qbar=last_qbar,
        n_total=n_total, n_blocked=n_blocked)
    out = MonitorOutput(
        q=torch.where(window_ready, q, 0.0),
        qbar=qbar,
        sigma_qbar=sigma_qbar,
        converged=converged,
        estimate=last_qbar,
        epoch=epoch)
    return new_state, out


def run_monitor(cfg: MonitorConfig, tc_seq, blocked_seq=None,
                dtype=torch.float32, *, device="cuda") -> MonitorOutput:
    """Drive the monitor over a whole sample stream, one period per step.

    The last axis of ``tc_seq`` is time; any leading axes are a batch of
    independent queues (a (Q, T) input replaces ``vmap`` over queues).
    Returns ``MonitorOutput`` with leaves shaped like ``tc_seq``.
    """
    dev = resolve_device(device)
    tc_seq = torch.as_tensor(tc_seq, dtype=dtype, device=dev)
    if blocked_seq is None:
        blocked_seq = torch.zeros(tc_seq.shape, dtype=torch.bool,
                                  device=dev)
    else:
        blocked_seq = torch.as_tensor(blocked_seq, dtype=torch.bool,
                                      device=dev)
    state = monitor_init(cfg, dtype, tc_seq.shape[:-1], dev)
    outs = []
    for t in range(tc_seq.shape[-1]):
        state, out = monitor_update(cfg, state, tc_seq[..., t],
                                    blocked_seq[..., t])
        outs.append(out)
    return MonitorOutput(*(torch.stack(parts, dim=-1)
                           for parts in zip(*outs)))


# ---------------------------------------------------------------------------
# Fleet-scale time-batched monitor (the fused CUDA hot path).
# ---------------------------------------------------------------------------

class FleetMonitorState(NamedTuple):
    """Algorithm-1 state for Q queues at once, laid out for the fused
    (Q, T) estimators.  Everything is *chronological* (newest entry
    last); there are no ring heads and no saturating fill counters —
    every gate the sequential algorithm expressed through fills is a pure
    function of ``count`` (q-bar fill = min(count, cw), sigma-trace fill
    = min(count, cw+2), response fill = min(count-2, cw)), because all
    three buffers advance on exactly the same fold events.

    The sigma trace is reduced to its two most recent values (the LoG
    stencil has radius 1; older trace entries survive only through the
    response history).  All leaves have leading dim Q and live on one
    device; the CUDA kernel updates them in place.
    """
    win: torch.Tensor        # (Q, window) last valid samples, newest last
    s_fill: torch.Tensor     # (Q,) int32 saturating valid-sample count
    count: torch.Tensor      # (Q,) Welford n        (float, matches stats)
    mean: torch.Tensor       # (Q,) Welford mean  == q-bar
    m2: torch.Tensor         # (Q,) Welford M2
    qhist: torch.Tensor      # (Q, conv_window) recent q-bar folds
    shist: torch.Tensor      # (Q, 2) [sigma(t-2), sigma(t-1)]
    rhist: torch.Tensor      # (Q, conv_window) recent LoG responses
    epoch: torch.Tensor      # (Q,) int32
    last_qbar: torch.Tensor  # (Q,) last converged estimate
    n_total: torch.Tensor    # (Q,) int32
    n_blocked: torch.Tensor  # (Q,) int32


_INT_LEAVES = ("s_fill", "epoch", "n_total", "n_blocked")


def fleet_monitor_init(cfg: MonitorConfig, n_queues: int,
                       dtype=torch.float32, *,
                       device="cuda") -> FleetMonitorState:
    dev = resolve_device(device)
    q = n_queues

    def f(*s):
        return torch.zeros(s, dtype=dtype, device=dev)

    def i(*s):
        return torch.zeros(s, dtype=torch.int32, device=dev)

    return FleetMonitorState(
        win=f(q, cfg.window), s_fill=i(q),
        count=f(q), mean=f(q), m2=f(q),
        qhist=f(q, cfg.conv_window), shist=f(q, 2),
        rhist=f(q, cfg.conv_window),
        epoch=i(q), last_qbar=f(q), n_total=i(q), n_blocked=i(q))


def fleet_state_from_numpy(leaves: dict, device="cuda",
                           dtype=torch.float32) -> FleetMonitorState:
    """Build the port's state from a ``FleetMonitorState``'s leaves as
    numpy arrays (e.g. ``{k: np.asarray(v) for k, v in
    jax_state._asdict().items()}``), so a fleet's estimator state carries
    across from the JAX package mid-stream."""
    dev = resolve_device(device)
    missing = set(FleetMonitorState._fields) - set(leaves)
    if missing:
        raise ValueError(f"state leaves missing: {sorted(missing)}")
    return FleetMonitorState(**{
        k: torch.as_tensor(np.array(leaves[k]), device=dev,
                           dtype=torch.int32 if k in _INT_LEAVES else dtype)
        for k in FleetMonitorState._fields})


def fleet_state_to_numpy(state: FleetMonitorState) -> dict:
    """The reverse of ``fleet_state_from_numpy``: host numpy copies."""
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}


_FLEET_BUILD_COUNT = [0]


def fleet_dispatch_trace_count() -> int:
    """How many fleet-dispatch plans the port has built (the twin of the
    JAX package's count of its jitted fleet step's traces).

    A plan is built once per (config, impl, mode, chunk_t, padded Q,
    device): ``run_monitor_fleet`` rounds the queue axis up to a
    ``block_q`` multiple for the key whether or not it pads the tile, so
    ragged fleet sizes share one plan.  Used by the rebuild-count tests.
    """
    return _FLEET_BUILD_COUNT[0]


class _FleetPlan(NamedTuple):
    """What one fleet dispatch reuses across calls: the compaction
    counts of an unblocked tile, on the device, for up to ``q_padded``
    queues (a smaller fleet takes the leading rows)."""
    cnt: torch.Tensor        # (q_padded, chunk_t) int32 running counts
    m: torch.Tensor          # (q_padded,) int32 valid counts = chunk_t


@functools.lru_cache(maxsize=None)
def _fleet_plan(cfg: MonitorConfig, impl: str, mode: str, chunk_t: int,
                q_padded: int, device: torch.device) -> _FleetPlan:
    _FLEET_BUILD_COUNT[0] += 1
    i32 = torch.int32
    return _FleetPlan(
        cnt=torch.arange(1, chunk_t + 1, dtype=i32,
                         device=device).expand(q_padded, chunk_t),
        m=torch.full((q_padded,), chunk_t, dtype=i32, device=device))


def _pad_rows(a: torch.Tensor, rpad: int, value=0) -> torch.Tensor:
    return F.pad(a, (0, 0) * (a.dim() - 1) + (0, rpad), value=value)


def _time_major(x: torch.Tensor) -> bool:
    """True for a (Q, T) view of a contiguous (T, Q) tensor (and not of
    a contiguous (Q, T) one)."""
    return not x.is_contiguous() and x.T.is_contiguous()


def _pad_tile(a: torch.Tensor, rows: int, cols: int, value=0):
    """A (Q, T) tile padded by ``rows`` rows and ``cols`` columns, in its
    own layout: the ``.T`` of a contiguous (T, Q) tensor stays one."""
    if _time_major(a):
        return F.pad(a.T, (0, rows, 0, cols), value=value).T
    return F.pad(a, (0, cols, 0, rows), value=value)


def run_monitor_fleet(cfg: MonitorConfig, tc_seq, blocked_seq=None, *,
                      state: FleetMonitorState | None = None,
                      chunk_t: int = 256, impl: str = "cuda",
                      mode: str = "full", interpret: bool = True,
                      block_q: int = 256, dtype=torch.float32,
                      donate: bool = False, pad_q: bool = True,
                      sub_t: int = 32, device="cuda"
                      ) -> tuple[FleetMonitorState, MonitorOutput | None]:
    """Drive the fused fleet estimator over (Q, T) sample streams.

    Consumes ``chunk_t`` samples per dispatch and carries
    ``FleetMonitorState`` across dispatches, so arbitrarily long streams
    run in fixed memory with a handful of launches.

    ``impl`` selects the execution path (see ``kernels.monitor.ops``):
    ``"cuda"`` (the fused kernel; its plain PyTorch version stands in
    only for tensors on the CPU), ``"rounds"`` (the segmented
    time-batched form, the host fast path, in sub-tiles of ``sub_t``
    steps) or ``"scan"`` (the plain sequential version on any device).  ``mode="full"`` returns a ``MonitorOutput``
    whose (Q, T) leaves are step-for-step identical to ``run_monitor``;
    ``mode="state"`` skips per-step outputs (converged estimates and
    epochs live in the state) and returns ``(state, None)`` — the
    production configuration for large fleets.

    ``tc_seq``/``blocked_seq`` may be row-major (Q, T) or the time-major
    ``.T`` view of a contiguous (T, Q) tensor, the monitoring service's
    staging layout; the kernel reads either, and padding keeps it.
    ``pad_q`` (default) pads the queue axis up to a ``block_q`` multiple
    with always-blocked rows, and a short tail chunk is padded to
    ``chunk_t`` with blocked steps, so every dispatch of one service has
    one shape; the kernel needs neither, and ``pad_q=False`` spares the
    copies of the state that the queue padding makes.  Either way the
    dispatch plan (``fleet_dispatch_trace_count``) is cached per
    (config, impl, mode, chunk_t, Q rounded up to ``block_q``, device).  ``donate=True``
    hands the state over: the kernel then updates the caller's state
    tensors in place (JAX's buffer donation becomes in-place updates on
    the device) and the passed-in ``state`` must not be reused.  Without
    it the caller's state is never mutated.  ``interpret`` is accepted
    for the JAX signature; there is nothing to interpret on the card.
    """
    del interpret
    dev = resolve_device(device)
    tc_seq = torch.as_tensor(tc_seq, dtype=dtype, device=dev)
    if tc_seq.dim() != 2:
        raise ValueError(f"tc_seq must be (Q, T), got {tuple(tc_seq.shape)}")
    Q, T = tc_seq.shape
    if blocked_seq is not None:
        blocked_seq = torch.as_tensor(blocked_seq, dtype=torch.bool,
                                      device=dev)
    if state is None:
        state = fleet_monitor_init(cfg, Q, dtype, device=dev)
        donate = True                      # a fresh state is ours
    elif any(leaf.device != dev for leaf in state):
        raise ValueError(f"state does not live on {dev}")

    from repro_torch.kernels.monitor.ops import _fleet_monitor_scan_impl

    q_padded = -(-Q // block_q) * block_q
    plan = _fleet_plan(cfg, impl, mode, chunk_t, q_padded, dev)
    rpad = q_padded - Q if pad_q else 0
    if rpad:                      # padded rows are permanently blocked
        if blocked_seq is None:
            blocked_seq = torch.zeros_like(tc_seq, dtype=torch.bool)
        tc_seq = _pad_tile(tc_seq, rpad, 0)
        blocked_seq = _pad_tile(blocked_seq, rpad, 0, value=True)
        state = FleetMonitorState(*(_pad_rows(a, rpad) for a in state))
        donate = True                      # the padded copy is ours

    outs = []
    for t0 in range(0, T, chunk_t):
        tc_c = tc_seq[:, t0:t0 + chunk_t]
        blk_c = (None if blocked_seq is None
                 else blocked_seq[:, t0:t0 + chunk_t])
        pad = chunk_t - tc_c.shape[1]
        if pad:                            # pad the tail chunk as blocked
            if blk_c is None:
                blk_c = torch.zeros_like(tc_c, dtype=torch.bool)
            tc_c = _pad_tile(tc_c, 0, pad)
            blk_c = _pad_tile(blk_c, 0, pad, value=True)
        state, out = _fleet_monitor_scan_impl(
            cfg, state, tc_c, blk_c, impl=impl, mode=mode, block_q=block_q,
            sub_t=sub_t, donate=donate, plan=plan)
        donate = True                      # later chunks update our copy
        if pad:                            # padded steps are not real
            state = state._replace(n_total=state.n_total - pad,
                                   n_blocked=state.n_blocked - pad)
        outs.append(out)
    if rpad:
        state = FleetMonitorState(*(a[:Q] for a in state))
    if mode != "full":
        return state, None
    merged = MonitorOutput(*(torch.cat(parts, dim=1)[:Q, :T]
                             for parts in zip(*outs)))
    return state, merged


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def gated_rate_arrays(cfg: MonitorConfig, epoch, count, mean, last,
                      period_s: float = 1.0) -> np.ndarray:
    """The readiness-gate formula on bare arrays: the last converged
    q-bar, else the running q-bar once ``min_q_samples`` folds
    accumulated, else 0 — one definition shared by the state readout
    below and the monitoring service's harvest-time mirrors, so the
    advisory and control-loop sense paths cannot drift.  Tensors on any
    device are read back to the host."""
    est = np.where(_host(epoch) > 0, _host(last),
                   np.where(_host(count) >= cfg.min_q_samples,
                            _host(mean), 0.0))
    return est / period_s if period_s > 0 else np.zeros_like(est)


def fleet_rate_readout(cfg: MonitorConfig, state: FleetMonitorState,
                       period_s: float = 1.0) -> np.ndarray:
    """Per-queue service-rate readout (items/s) with the Welford-count
    readiness gate.

    A queue that has converged at least once reports its last converged
    q-bar.  Before the first convergence the running q-bar is reported
    only once the current epoch has accumulated ``min_q_samples`` folds —
    never a raw partial-window sample, which is exactly the noise the
    paper's Algorithm 1 exists to filter out.  Unready queues report 0.
    """
    return gated_rate_arrays(cfg, state.epoch, state.count, state.mean,
                             state.last_qbar, period_s)


# ---------------------------------------------------------------------------
# Host-side implementation (the paper's monitor thread), float64 numpy.
# ---------------------------------------------------------------------------

_SUM = np.add.reduce


def _mean_std(a: np.ndarray) -> tuple:
    """``(np.mean(a), np.std(a))`` of a 1-D float64 array, bit for bit:
    the same ufunc reductions (pairwise sums) and divisions, without the
    wrappers' per-call Python cost."""
    n = a.shape[0]
    m = _SUM(a) / n
    d = a - m
    return m, math.sqrt(_SUM(d * d) / n)


def _dot(vals: list, taps: tuple) -> float:
    """One output of ``filters.convolve_valid``: the products summed in
    its order, in float64."""
    acc = vals[0] * taps[0]
    for i in range(1, len(taps)):
        acc = acc + vals[i] * taps[i]
    return acc


class _Ring:
    """The last ``n`` float64 values, oldest first, as one contiguous
    view: each value is stored at i and i + n, an O(1) push (two
    stores) instead of an O(n) shift."""

    __slots__ = ("buf", "n", "head", "fill")

    def __init__(self, n: int):
        self.buf = np.zeros(2 * n)
        self.n = n
        self.head = n - 1
        self.fill = 0

    def push(self, x: float) -> None:
        h = self.head + 1
        if h == self.n:
            h = 0
        self.head = h
        self.buf[h] = self.buf[h + self.n] = x
        if self.fill < self.n:
            self.fill += 1

    def view(self) -> np.ndarray:
        return self.buf[self.head + 1:self.head + 1 + self.n]

    def newest(self, k: int) -> list:
        """The newest ``k`` values, oldest first, as python floats."""
        e = self.head + 1 + self.n
        return self.buf[e - k:e].tolist()


class HostMonitor:
    """Per-queue online monitor for the host pipeline threads.

    Same algorithm as ``monitor_update`` in float64; kept dependency-light
    (numpy only) because it runs on the instrumentation thread and must obey
    the paper's low-overhead contract (1-2%).  Each sample adds one
    Gaussian-filtered value and each fold one LoG response, so both
    filters keep their outputs in rings and compute only the newest, and
    the reductions call the ufuncs bare: the arithmetic of
    ``filters.convolve_valid`` and ``np.std`` on the same values in the
    same order, bit for bit, at a fraction of the per-call cost (a
    ``ReplicaSupervisor`` folds one sample per replica every poll).
    """

    def __init__(self, cfg: MonitorConfig | None = None, *,
                 period_s: float = 1e-3, item_bytes: float = 1.0):
        self.cfg = cfg or MonitorConfig()
        self.period_s = float(period_s)
        self.item_bytes = float(item_bytes)
        c = self.cfg
        self._gauss = filters.gaussian_kernel(
            c.gauss_radius, c.gauss_sigma, normalize=c.gauss_normalize)
        self._log = filters.log_kernel(c.log_radius, c.log_sigma)
        self._gauss_t = tuple(float(k) for k in self._gauss)
        self._log_t = tuple(float(k) for k in self._log)
        self.n_total = 0
        self.n_blocked = 0
        self.epoch = 0
        self.last_qbar = 0.0
        self.estimates: list[float] = []   # converged q-bar per epoch
        # the window S and its Gaussian-filtered values S' (Eq. 2);
        # neither resets with the statistics
        self._s = _Ring(c.window)
        self._sp = _Ring(c.window - len(self._gauss_t) + 1)
        self._reset_stats()

    # -- Algorithm 1's resetStats() ----------------------------------------
    def _reset_stats(self):
        c = self.cfg
        self._n = 0
        self._mean = 0.0
        self._m2 = 0.0
        self._qbars = _Ring(c.conv_window)
        self._sigs = _Ring(c.sig_trace_len)
        # the LoG responses over the sigma trace (Eq. 4)
        self._resp = _Ring(c.sig_trace_len - len(self._log_t) + 1)

    def update(self, tc: float, blocked: bool = False) -> bool:
        """Ingest one period's sample; returns True if converged+emitted."""
        c = self.cfg
        self.n_total += 1
        if blocked:
            self.n_blocked += 1
            return False
        s, taps = self._s, self._gauss_t
        s.push(tc)
        if s.fill >= len(taps):
            self._sp.push(_dot(s.newest(len(taps)), taps))
        if s.fill < c.window:
            return False

        m, sd = _mean_std(self._sp.view())
        q = float(m + c.quantile_z * sd)

        self._n += 1
        delta = q - self._mean
        self._mean += delta / self._n
        self._m2 += delta * (q - self._mean)
        qbar = self._mean

        qbars = self._qbars
        qbars.push(qbar)
        if c.sigma_mode == "stderr":
            sig = math.sqrt(self._m2 / self._n / self._n) if self._n else 0.0
        else:
            sig = (_mean_std(qbars.view())[1]
                   if qbars.fill >= c.conv_window else _BIG)
        sigs, taps = self._sigs, self._log_t
        sigs.push(sig)
        if sigs.fill >= len(taps):
            self._resp.push(_dot(sigs.newest(len(taps)), taps))

        if sigs.fill < c.sig_trace_len or self._n < c.min_q_samples:
            return False
        resp = max(map(abs, self._resp.view().tolist()))
        if not math.isfinite(resp):
            return False
        tol = c.conv_tol * (max(abs(qbar), 1e-12)
                            if c.conv_tol_mode == "rel" else 1.0)
        if resp >= tol:
            return False

        self.last_qbar = qbar
        self.estimates.append(qbar)
        self.epoch += 1
        self._reset_stats()
        return True

    # -- readouts ------------------------------------------------------------
    @property
    def qbar(self) -> float:
        return self._mean if self._n else self.last_qbar

    def rate_items_per_s(self) -> float:
        q = self.last_qbar if self.epoch else self.qbar
        return q / self.period_s if self.period_s > 0 else 0.0

    def rate_bytes_per_s(self) -> float:
        return self.rate_items_per_s() * self.item_bytes

    def observed_blocking_fraction(self) -> float:
        return self.n_blocked / self.n_total if self.n_total else 0.0


# ---------------------------------------------------------------------------
# Sampling-period determination (paper §IV-A).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SamplingPeriodController:
    """Find the widest stable sampling period T (paper Fig. 6).

    Start at the timing mechanism's minimum latency and lengthen T while
    (1) no blockage occurred at either queue end in the last ``k`` periods
    and (2) the realized period stayed within ``eps`` of target for the last
    ``j`` periods.  If T cannot stabilize at the minimum, the method *fails
    knowingly* (``failed`` is set) — the paper's stated behavior.
    """
    base_latency_s: float = 300e-9     # paper: ~50-300 ns timer latency
    max_period_s: float = 10e-3        # ~ scheduler quantum
    k_no_block: int = 8
    j_stable: int = 8
    eps_rel: float = 0.25
    growth: float = 2.0

    def __post_init__(self):
        self.period_s = self.base_latency_s
        self._no_block_run = 0
        self._stable_run = 0
        self._unstable_run = 0
        self.failed = False

    def observe(self, realized_period_s: float, blocked: bool) -> float:
        """Report one period's outcome; returns the (possibly new) T."""
        stable = (abs(realized_period_s - self.period_s)
                  <= self.eps_rel * self.period_s)
        self._stable_run = self._stable_run + 1 if stable else 0
        self._unstable_run = 0 if stable else self._unstable_run + 1
        self._no_block_run = 0 if blocked else self._no_block_run + 1

        if (self._no_block_run >= self.k_no_block
                and self._stable_run >= self.j_stable
                and self.period_s * self.growth <= self.max_period_s):
            self.period_s *= self.growth
            self._no_block_run = 0
            self._stable_run = 0
        elif self._unstable_run >= self.j_stable:
            if self.period_s <= self.base_latency_s * 1.0001:
                self.failed = True     # cannot stabilize even at minimum
            else:
                self.period_s = max(self.period_s / self.growth,
                                    self.base_latency_s)
            self._unstable_run = 0
        return self.period_s
