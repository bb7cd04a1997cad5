"""Queueing model: paper Eq. 1 plus the M/M/1/K machinery the run-time uses.

Eq. 1 (a Kleinrock-derived modification) gives the probability of observing a
*non-blocking* read / write over a sampling period T for an M/M/1 station —
the quantity that determines whether the monitor can see the latent service
rate at all (paper Fig. 4), and which drives the sampling-period controller.

The buffer-sizing functions below are what ``core.controller.BufferAutotuner``
uses to turn two monitored service rates (producer lambda, consumer mu) into
a queue capacity, replacing branch-and-bound reallocation — the paper's
motivating use case (Fig. 2).

The formulas take python floats or tensors and return tensors; the
default float dtype is float32, as in the JAX package.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "k_items",
    "pr_nonblocking_read",
    "pr_nonblocking_write",
    "mm1k_blocking_prob",
    "mm1k_throughput",
    "mm1k_mean_occupancy",
    "md1k_throughput_approx",
    "optimal_buffer_size",
    "optimal_buffer_size_fleet",
]


def _t(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, dtype=torch.float32)


def k_items(mu_s, T):
    """Eq. 1a: k = ceil(mu_s * T) — items the server consumes during T."""
    return torch.ceil(_t(mu_s) * T)


def pr_nonblocking_read(T, rho, mu_s):
    """Eq. 1b/1c: Pr[READ](T, rho, mu_s) = rho^k with k = ceil(mu_s T).

    Probability that the in-bound queue holds at least the k items the server
    needs for the whole period (so no read ever blocks during T).
    """
    k = k_items(mu_s, T)
    return _t(rho) ** k


def pr_nonblocking_write(T, C, rho, mu_s):
    """Eq. 1d: 1 - rho^(C - k + 1) if C >= mu_s*T else 0.

    Probability the out-bound queue (capacity C) retains space for the
    server's entire output over the period.
    """
    k = k_items(mu_s, T)
    rho = _t(rho)
    p = 1.0 - rho ** (C - k + 1.0)
    return torch.where(_t(C) >= _t(mu_s) * T, p, 0.0)


def mm1k_blocking_prob(lam, mu, K):
    """P_K for M/M/1/K: probability an arrival finds the buffer full."""
    rho = _t(lam) / mu
    # rho == 1 limit: P_K = 1/(K+1)
    near1 = torch.abs(rho - 1.0) < 1e-9
    safe_rho = torch.where(near1, 0.5, rho)
    p = (1.0 - safe_rho) * safe_rho ** K / (1.0 - safe_rho ** (K + 1.0))
    return torch.where(near1, 1.0 / (_t(K) + 1.0), p)


def mm1k_throughput(lam, mu, K):
    """Accepted throughput of an M/M/1/K station: lam * (1 - P_K)."""
    return lam * (1.0 - mm1k_blocking_prob(lam, mu, K))


def mm1k_mean_occupancy(lam, mu, K):
    rho = _t(lam) / mu
    near1 = torch.abs(rho - 1.0) < 1e-9
    safe_rho = torch.where(near1, 0.5, rho)
    n = (safe_rho / (1.0 - safe_rho)
         - (K + 1.0) * safe_rho ** (K + 1.0) / (1.0 - safe_rho ** (K + 1.0)))
    return torch.where(near1, _t(K) / 2.0, n)


def md1k_throughput_approx(lam, mu, K):
    """M/D/1/K accepted-throughput approximation.

    Deterministic service halves queueing variability; we use the standard
    two-moment interpolation (a G/M/1-style cv^2 scaling of the M/M/1/K
    blocking exponent).  Selected by the distribution classifier when the
    monitored service process looks deterministic (cv^2 ~ 0).
    """
    # Effective capacity grows ~2x for D service (Kramer/Langenbach-Belz
    # style two-moment correction with cv^2 = 0 -> exponent doubles).
    K_eff = 2.0 * K - 1.0
    return mm1k_throughput(lam, mu, K_eff)


def optimal_buffer_size(lam, mu, *, target_frac: float = 0.99,
                        max_k: int = 1 << 16, cv2: float = 1.0) -> int:
    """Smallest capacity K whose accepted throughput reaches
    ``target_frac * min(lam, mu)`` — the analytic replacement for the
    paper's branch-and-bound buffer search.

    ``cv2`` (squared coefficient of variation of the *service* process,
    from the streaming moment estimator) selects between the M/M/1/K
    (cv2 >= 0.5) and M/D/1/K (cv2 < 0.5) models.
    """
    lam = float(lam)
    mu = float(mu)
    if lam <= 0 or mu <= 0:
        return 1
    target = target_frac * min(lam, mu)
    thr_fn = mm1k_throughput if cv2 >= 0.5 else md1k_throughput_approx
    # Galloping + binary search on monotone thr(K).
    lo, hi = 1, 2
    while hi < max_k and float(thr_fn(lam, mu, hi)) < target:
        lo, hi = hi, hi * 2
    hi = min(hi, max_k)
    while lo < hi:
        mid = (lo + hi) // 2
        if float(thr_fn(lam, mu, mid)) >= target:
            hi = mid
        else:
            lo = mid + 1
    return int(lo)


def _buffer_size_search(lam, mu, cv2, target_frac: float, max_k: int):
    """Fleet-capacity search as a fixed number of vectorized steps: the
    gallop and bisection schedules depend only on ``max_k``, so every
    call runs the same short loop of whole-fleet tensor ops."""
    lam, mu, cv2 = torch.broadcast_tensors(lam, mu, cv2)
    target = target_frac * torch.minimum(lam, mu)

    def thr(k):
        return torch.where(cv2 >= 0.5, mm1k_throughput(lam, mu, k),
                           md1k_throughput_approx(lam, mu, k))

    # Per-element galloping, then bisection — the same schedule as the
    # scalar search.  Galloping matters beyond speed: for rho > 1 the
    # blocking-probability formula NaNs out at huge K (rho**K overflows),
    # so probing mid = max_k/2 first would never observe the small-K
    # passes; doubling from 2 finds them exactly as the scalar loop does.
    lo = torch.ones(lam.shape, dtype=torch.int32, device=lam.device)
    hi = torch.full(lam.shape, 2, dtype=torch.int32, device=lam.device)
    h = 2
    while h < max_k:
        failing = ~(thr(hi.to(torch.float32)) >= target) & (hi < max_k)
        lo = torch.where(failing, hi, lo)
        hi = torch.where(failing, torch.clamp(hi * 2, max=int(max_k)), hi)
        h *= 2
    for _ in range(max(1, math.ceil(math.log2(max(max_k, 2)))) + 1):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        use = lo < hi
        ok = thr(mid.to(torch.float32)) >= target
        hi = torch.where(use & ok, mid, hi)
        lo = torch.where(use & ~ok, mid + 1, lo)
    return torch.where((lam > 0) & (mu > 0), lo, 1)


def optimal_buffer_size_fleet(lam, mu, *, target_frac: float = 0.99,
                              max_k: int = 1 << 16, cv2=1.0):
    """Vectorized ``optimal_buffer_size`` over (Q,) rate arrays.

    One evaluation for the whole fleet: a fixed ``ceil(log2(max_k))``-step
    gallop + bisection on the monotone accepted-throughput curve, with
    each queue routed elementwise to the M/M/1/K or (``cv2 < 0.5``)
    M/D/1/K model.  Agrees with the scalar search for every element;
    queues with non-positive rates report capacity 1 (the scalar
    function's unobservable-rates answer).  Runs on the device of
    ``lam`` when it is a tensor, else on the CPU.
    """
    dev = lam.device if isinstance(lam, torch.Tensor) else "cpu"

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    return _buffer_size_search(f32(lam), f32(mu), f32(cv2),
                               float(target_frac), int(max_k))


def expected_nonblocking_fraction(T, C, rho, mu_s) -> float:
    """Joint probability that a whole period is non-blocking at both ends
    (independence approximation) — used by the sampling-period controller to
    predict whether a candidate T can ever yield usable samples."""
    pr = float(pr_nonblocking_read(T, rho, mu_s))
    pw = float(pr_nonblocking_write(T, C, rho, mu_s))
    return pr * pw
