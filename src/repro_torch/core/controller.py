"""Run-time controllers that consume monitored service rates.

This is the paper's "so what": once every queue's non-blocking service rate
is known online, the run-time can (a) size buffers analytically instead of
branch-and-bound re-allocating (Fig. 2), (b) make informed duplication /
parallelization decisions (Gordon et al., Li et al.), and (c) — our
pod-scale extension — detect stragglers as service-rate phase changes
(paper Figs. 10/14/15 generalized to per-host step streams).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np

from repro_torch.core import queueing
from repro_torch.core.stats import Moments, moments_finalize, moments_init, \
    moments_update, moments_update_batch

__all__ = [
    "BufferAutotuner",
    "ParallelismController",
    "StragglerDetector",
    "DistributionClassifier",
]


@dataclasses.dataclass
class BufferAutotuner:
    """Analytic queue-capacity controller.

    Given converged estimates of the producer rate (lambda) and consumer
    rate (mu) of one queue, recommend the smallest capacity K achieving
    ``target_frac`` of the saturation throughput, with hysteresis so we only
    re-allocate when the recommendation moves by more than
    ``resize_factor`` x (re-allocation itself perturbs the system — the
    paper resizes sparingly and only when informative).
    """
    target_frac: float = 0.99
    resize_factor: float = 1.5
    min_capacity: int = 4
    max_capacity: int = 1 << 20
    current: int = 64

    def recommend(self, lam: float, mu: float, cv2: float = 1.0) -> int:
        if lam <= 0 or mu <= 0:
            return self.current
        k = queueing.optimal_buffer_size(
            lam, mu, target_frac=self.target_frac, cv2=cv2,
            max_k=self.max_capacity)
        return int(np.clip(k, self.min_capacity, self.max_capacity))

    def maybe_resize(self, lam: float, mu: float, cv2: float = 1.0
                     ) -> tuple[int, bool]:
        rec = self.recommend(lam, mu, cv2)
        ratio = rec / max(self.current, 1)
        if ratio >= self.resize_factor or ratio <= 1.0 / self.resize_factor:
            self.current = rec
            return rec, True
        return self.current, False

    # -- fleet forms: (Q,) rate arrays in, (Q,) capacities out ------------
    def recommend_fleet(self, lam, mu, cv2=1.0, current=None) -> np.ndarray:
        """Vectorized ``recommend``: one fused evaluation sizes every
        queue in the fleet.  Queues with unobservable rates keep
        ``current`` (per-queue array, or the scalar tuner default)."""
        lam = np.asarray(lam, float)
        mu = np.asarray(mu, float)
        cur = (np.full(lam.shape, self.current, np.int64)
               if current is None else np.asarray(current, np.int64))
        k = np.asarray(queueing.optimal_buffer_size_fleet(
            lam, mu, target_frac=self.target_frac, cv2=cv2,
            max_k=self.max_capacity))
        k = np.clip(k, self.min_capacity, self.max_capacity)
        return np.where((lam > 0) & (mu > 0), k, cur).astype(np.int64)

    def maybe_resize_fleet(self, lam, mu, current, cv2=1.0
                           ) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized ``maybe_resize`` against a per-queue ``current``
        capacity array; returns ``(new_capacities, resized_mask)`` with
        the same hysteresis band as the scalar form."""
        cur = np.asarray(current, np.int64)
        rec = self.recommend_fleet(lam, mu, cv2, current=cur)
        ratio = rec / np.maximum(cur, 1)
        resized = (ratio >= self.resize_factor) \
            | (ratio <= 1.0 / self.resize_factor)
        return np.where(resized, rec, cur), resized

    def actuate_fleet(self, queues, lam, mu, current, cv2=1.0
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``maybe_resize_fleet`` as an *actuator*: apply the decisions
        to live queues (anything with ``resize(int) -> bool``) instead
        of returning advice the caller must mirror by hand.

        Returns ``(capacities, applied, rejected)``: the post-actuation
        per-queue capacity array (rejected shrinks keep the real,
        current capacity so the shrink retries once the queue drains —
        items are never dropped), plus the applied / rejected masks."""
        cur = np.asarray(current, np.int64)
        new_caps, resized = self.maybe_resize_fleet(lam, mu, cur, cv2)
        applied = np.zeros(len(queues), bool)
        rejected = np.zeros(len(queues), bool)
        for i in np.nonzero(resized)[0]:
            if queues[i].resize(int(new_caps[i])):
                applied[i] = True
            else:
                rejected[i] = True
                new_caps[i] = cur[i]
        return new_caps, applied, rejected


@dataclasses.dataclass
class ParallelismController:
    """Duplication decision: how many copies of a stage keep up with the
    offered load?  n = ceil(lambda_upstream / mu_stage * headroom)."""
    headroom: float = 1.2
    max_replicas: int = 64

    def replicas(self, upstream_rate: float, stage_rate: float) -> int:
        if stage_rate <= 0:
            return self.max_replicas
        n = math.ceil(self.headroom * upstream_rate / stage_rate)
        return int(np.clip(n, 1, self.max_replicas))

    def should_scale(self, current: int, upstream_rate: float,
                     stage_rate: float) -> tuple[int, bool]:
        n = self.replicas(upstream_rate, stage_rate)
        return n, n != current

    def replicas_fleet(self, upstream_rates, stage_rates) -> np.ndarray:
        """Vectorized ``replicas``: (Q,) rate arrays in, (Q,) replica
        counts out in one fused evaluation."""
        up = np.asarray(upstream_rates, float)
        mu = np.asarray(stage_rates, float)
        n = np.ceil(self.headroom * up / np.where(mu > 0, mu, 1.0))
        n = np.where(mu <= 0, self.max_replicas, n)
        return np.clip(n, 1, self.max_replicas).astype(np.int64)


@dataclasses.dataclass
class StragglerDetector:
    """Pod-scale phase-change detector.

    Each host feeds its converged step-rate estimates (q-bar per epoch) in;
    a host whose latest converged rate drops below ``threshold`` x the fleet
    median is flagged.  This is exactly the paper's dual-phase detection
    (Fig. 14) applied across hosts instead of across time.
    """
    threshold: float = 0.8
    min_hosts: int = 4

    def __post_init__(self):
        self.rates: dict[str, float] = {}

    def report(self, host: str, rate: float) -> None:
        if rate > 0:
            self.rates[host] = rate

    def report_fleet(self, hosts, rates) -> None:
        """Batch report: one call folds a whole fleet's converged rates
        into the registry (non-positive rates are unobserved, skipped)."""
        rates = np.asarray(rates, float)
        for host, rate in zip(hosts, rates):
            if rate > 0:
                self.rates[host] = float(rate)

    def straggler_mask(self, rates) -> np.ndarray:
        """Array-in/array-out phase-change detection without the host
        registry: flags entries below ``threshold`` x the median of the
        positive (observed) rates — one fused evaluation."""
        r = np.asarray(rates, float)
        pos = r > 0
        if int(pos.sum()) < self.min_hosts:
            return np.zeros(r.shape, bool)
        med = float(np.median(r[pos]))
        return pos & (r < self.threshold * med)

    def stragglers(self) -> list[str]:
        if len(self.rates) < self.min_hosts:
            return []
        med = float(np.median(list(self.rates.values())))
        return [h for h, r in self.rates.items()
                if r < self.threshold * med]

    def healthy_fraction(self) -> float:
        if not self.rates:
            return 1.0
        return 1.0 - len(self.stragglers()) / len(self.rates)


class DistributionClassifier:
    """Paper §VII: stream the service process's moments (Pebay) and classify
    the distribution so a closed-form model can be selected.

    cv^2 ~ 0   -> 'D'  (deterministic; use M/D/1/K sizing)
    cv^2 ~ 1   -> 'M'  (exponential; use M/M/1/K sizing)
    otherwise  -> 'G'  (general; fall back to conservative M/M/1/K)

    ``n_streams=None`` is the scalar classifier (one service process,
    float32 tensor moments).  ``n_streams=Q`` is the fleet form: every
    leaf of the moment state is a (Q,) numpy float64 array on the host,
    ``update_batch`` takes a (Q, B) tile (one vectorized evaluation for
    the whole fleet), and ``classify``/``cv2`` return (Q,) arrays.
    """

    def __init__(self, d_tol: float = 0.25, m_tol: float = 0.35,
                 n_streams: Optional[int] = None):
        self.d_tol = d_tol
        self.m_tol = m_tol
        self.n_streams = n_streams
        if n_streams is None:
            self._m: Moments = moments_init(device="cpu")
        else:
            self._m = Moments(*(np.zeros((n_streams,))
                                for _ in range(5)))

    def update(self, service_time: float) -> None:
        if self.n_streams is not None:
            raise ValueError("fleet classifier takes update_batch tiles")
        self._m = moments_update(self._m, service_time)

    def update_batch(self, service_times, where=None) -> None:
        """Fold a batch of service-time samples in one vectorized Pebay
        merge: (B,) for the scalar form, (Q, B) for the fleet form.
        ``where`` masks invalid samples (e.g. blocked periods)."""
        x = np.asarray(service_times, np.float64)
        if self.n_streams is None and x.ndim > 1:
            x = x.ravel()
        self._m = moments_update_batch(self._m, x, where=where)

    @property
    def counts(self) -> np.ndarray:
        return np.asarray(self._m.count)

    @property
    def cv2(self):
        # numpy fast path for just the cv2 leg: the control loop reads
        # this every tick, where three host copies + two divides do
        count = np.asarray(self._m.count)
        mean = np.asarray(self._m.mean)
        m2 = np.asarray(self._m.m2)
        var = m2 / np.where(count > 0, count, 1.0)
        out = np.where(mean != 0.0, var / np.where(mean != 0.0,
                                                   mean * mean, 1.0), 0.0)
        return float(out) if self.n_streams is None else out

    def classify(self):
        count = np.asarray(self._m.count)
        cv2 = np.asarray(moments_finalize(self._m)[4])
        ready = count >= 16
        is_d = ready & (cv2 < self.d_tol)
        is_m = ready & ~is_d & (np.abs(cv2 - 1.0) < self.m_tol)
        if self.n_streams is None:
            return "D" if is_d else ("M" if is_m else "G")
        out = np.full(count.shape, "G", dtype="<U1")
        out[is_d] = "D"
        out[is_m] = "M"
        return out

    def sizing_fn(self) -> Callable:
        if self.n_streams is not None:
            raise ValueError("fleet classifier feeds cv2 arrays to "
                             "BufferAutotuner.recommend_fleet instead")
        return (queueing.md1k_throughput_approx if self.classify() == "D"
                else queueing.mm1k_throughput)
