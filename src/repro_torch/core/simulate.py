"""Discrete-event simulation of the paper's micro-benchmark.

Two kernels A -> [queue, capacity C] -> B (paper Fig. 1).  Produces exactly
what the real instrumentation sees: per-period non-blocking transaction
counts ``tc`` plus ``blocked`` booleans at the queue head (departures into
B), with the measurement pathologies the paper enumerates — partial firings
at period boundaries, counter-clear races, and outlier noise (cache/
interrupt/context-switch spikes, Fig. 3).

Used as ground truth by the tests and by the per-figure benchmarks
(Figs. 3, 7-10, 13-15).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TandemConfig", "TandemResult", "simulate_tandem",
           "sample_periods", "sample_periods_fleet"]


@dataclasses.dataclass(frozen=True)
class TandemConfig:
    mu_a: float = 4.0e5            # producer service rate, items/s
    mu_b: float = 2.0e5            # consumer (monitored) rate, items/s
    dist_a: str = "exponential"    # 'exponential' | 'deterministic'
    dist_b: str = "exponential"
    capacity: int = 64             # queue capacity C
    n_items: int = 200_000
    # Phase shift (paper Figs. 10/14/15): after `phase_frac` of the items,
    # B's mean rate switches to `mu_b2` (None = single phase).
    mu_b2: float | None = None
    phase_frac: float = 0.5
    seed: int = 0


@dataclasses.dataclass
class TandemResult:
    arrive_t: np.ndarray   # time item i entered the queue (A finished)
    depart_t: np.ndarray   # time item i left queue into B (B started)
    finish_t: np.ndarray   # time B finished item i
    starved: np.ndarray    # bool: B waited on an empty queue before item i
    cfg: TandemConfig


def _service(rng: np.random.Generator, dist: str, mean_t: float, n: int):
    if dist == "exponential":
        return rng.exponential(mean_t, n)
    if dist == "deterministic":
        return np.full(n, mean_t)
    raise ValueError(f"unknown distribution {dist!r}")


def simulate_tandem(cfg: TandemConfig) -> TandemResult:
    """Event-driven tandem queue with finite buffer (blocking-after-service).

    Recurrences (t_a[i] = A pushes item i, t_b[i] = B finishes item i):
      t_a[i] = max(t_a[i-1], t_b[i-C]) + a[i]      (wait for space)
      start  = max(t_a[i], t_b[i-1])               (wait for item / self)
      t_b[i] = start + b[i]
    """
    rng = np.random.default_rng(cfg.seed)
    n = cfg.n_items
    a = _service(rng, cfg.dist_a, 1.0 / cfg.mu_a, n)
    if cfg.mu_b2 is None:
        b = _service(rng, cfg.dist_b, 1.0 / cfg.mu_b, n)
    else:
        n1 = int(n * cfg.phase_frac)
        b = np.concatenate([
            _service(rng, cfg.dist_b, 1.0 / cfg.mu_b, n1),
            _service(rng, cfg.dist_b, 1.0 / cfg.mu_b2, n - n1)])

    t_a = np.empty(n)
    t_b = np.empty(n)
    starved = np.zeros(n, dtype=bool)
    C = cfg.capacity
    prev_a = 0.0
    prev_b = 0.0
    for i in range(n):
        space_free = t_b[i - C] if i >= C else 0.0
        ta = max(prev_a, space_free) + a[i]
        start = ta if ta > prev_b else prev_b
        starved[i] = ta > prev_b      # B idled waiting for this item
        tb = start + b[i]
        t_a[i] = ta
        t_b[i] = tb
        prev_a, prev_b = ta, tb
    depart = np.maximum(t_a, np.concatenate([[0.0], t_b[:-1]]))
    return TandemResult(arrive_t=t_a, depart_t=depart, finish_t=t_b,
                        starved=starved, cfg=cfg)


def sample_periods(res: TandemResult, period_s: float, *,
                   timer_jitter_rel: float = 0.02,
                   outlier_prob: float = 0.01,
                   outlier_scale: float = 2.0,
                   clear_race_prob: float = 0.02,
                   seed: int = 1):
    """Convert event times into what the monitor thread actually samples.

    Returns (tc, blocked, t_grid):
      tc[k]      — departures from the queue into B during period k, after
                   measurement noise;
      blocked[k] — True if B starved (queue empty) at any point in period k
                   (the Lancaster-style state filter discards these).

    Noise model (paper §II-III): period boundaries jitter (timer noise),
    occasional counter-clear races move counts between adjacent periods, and
    rare outlier spikes multiply a sample (cache/interrupt artifacts).
    """
    rng = np.random.default_rng(seed)
    t_end = res.finish_t[-1]
    n_periods = max(int(t_end / period_s) - 1, 1)
    edges = np.arange(n_periods + 1) * period_s
    if timer_jitter_rel > 0:
        edges = edges + rng.normal(0.0, timer_jitter_rel * period_s,
                                   edges.shape)
        edges = np.maximum.accumulate(edges)   # keep monotone

    tc = np.histogram(res.depart_t, bins=edges)[0].astype(np.float64)
    starve_t = res.depart_t[res.starved]
    blocked = np.histogram(starve_t, bins=edges)[0] > 0

    # counter-clear race: a fraction of one period's tail lands in the next.
    race = rng.random(n_periods) < clear_race_prob
    frac = rng.random(n_periods) * 0.5
    moved = np.where(race, np.floor(tc * frac), 0.0)
    tc = tc - moved
    tc[1:] += moved[:-1]

    # two-sided outliers: cache/interrupt artifacts "conspire to speed up or
    # slow down (momentarily) the service rate" (paper §IV-B).
    out = rng.random(n_periods) < outlier_prob
    factor = np.exp(rng.uniform(-np.log(outlier_scale),
                                np.log(outlier_scale), n_periods))
    tc = np.where(out, tc * factor, tc)
    return tc, blocked, edges[:-1]


def sample_periods_fleet(results, period_s: float, *, n_periods=None,
                         seed: int = 1, **noise):
    """Batch many tandem simulations into fleet-shaped sample planes.

    ``results`` is a list of :class:`TandemResult` (one per monitored
    queue).  Each is sampled with :func:`sample_periods` and the rows are
    stacked into ``(tc (Q, T), blocked (Q, T))`` — the exact input layout
    of ``repro_torch.core.monitor.run_monitor_fleet`` and the fused
    CUDA fleet kernel.  Shorter streams are padded with blocked=True periods
    (the monitor discards them), so ragged simulations batch cleanly.
    """
    rows = []
    for i, res in enumerate(results):
        tc, blocked, _ = sample_periods(res, period_s, seed=seed + i,
                                        **noise)
        rows.append((tc, blocked))
    T = max(len(tc) for tc, _ in rows) if n_periods is None else n_periods
    Q = len(rows)
    tc_f = np.zeros((Q, T))
    blk_f = np.ones((Q, T), dtype=bool)
    for qi, (tc, blocked) in enumerate(rows):
        n = min(len(tc), T)
        tc_f[qi, :n] = tc[:n]
        blk_f[qi, :n] = blocked[:n]
    return tc_f, blk_f
