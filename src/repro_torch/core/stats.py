"""Streaming statistics: Welford/Chan mean+variance and Pebay higher moments.

The paper's Algorithm 1 presumes "an implementation of a streaming mean and
standard deviation (see Welford and Chan et al.)" — updateStats(),
updateMeanQ(), resetStats().  Section VII additionally proposes streaming
higher moments (Pebay, SAND2008-6212) so the run-time can classify the
service process distribution; we implement those too and use them in
``core.controller.DistributionClassifier``.

All states are NamedTuples whose leaves are torch tensors of any shape
(a (Q,) leaf is a whole fleet) or, on the host, numpy float64 arrays and
python floats.  Every function computes in the namespace of its inputs:
torch for tensors, numpy otherwise.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.device import resolve_device

__all__ = [
    "Welford",
    "welford_init",
    "welford_update",
    "welford_merge",
    "welford_mean",
    "welford_variance",
    "welford_std",
    "welford_stderr",
    "Moments",
    "moments_init",
    "moments_update",
    "moments_update_batch",
    "moments_merge",
    "moments_finalize",
]


def _is_torch(*xs) -> bool:
    return any(isinstance(x, torch.Tensor) for x in xs)


def _where(cond, a, b):
    if _is_torch(cond, a, b):
        return torch.where(torch.as_tensor(cond), a, b)
    return np.where(cond, a, b)


def _sqrt(x):
    return torch.sqrt(x) if _is_torch(x) else np.sqrt(x)


class Welford(NamedTuple):
    count: torch.Tensor  # float (float keeps the whole state one dtype)
    mean: torch.Tensor
    m2: torch.Tensor


def welford_init(dtype=torch.float32, shape=(), device="cuda") -> Welford:
    """Empty statistics on ``device`` (the card by default; without one
    this raises: pass ``device="cpu"`` for the host)."""
    z = torch.zeros(shape, dtype=dtype, device=resolve_device(device))
    return Welford(count=z, mean=z, m2=z)


def welford_update(state: Welford, x) -> Welford:
    """Single-observation update (Welford 1962).  The op order is part of
    the contract: the fleet fold (``kernels.monitor.ref.fleet_step`` and
    the CUDA kernel) repeats it exactly."""
    count = state.count + 1.0
    delta = x - state.mean
    mean = state.mean + delta / count
    m2 = state.m2 + delta * (x - mean)
    return Welford(count=count, mean=mean, m2=m2)


def welford_merge(a: Welford, b: Welford) -> Welford:
    """Pairwise merge (Chan, Golub & LeVeque 1983) — used to combine
    per-host monitor statistics across a pod without shipping raw samples."""
    count = a.count + b.count
    safe = _where(count > 0, count, 1.0)
    delta = b.mean - a.mean
    mean = a.mean + delta * (b.count / safe)
    m2 = a.m2 + b.m2 + delta * delta * (a.count * b.count / safe)
    return Welford(count=count, mean=mean, m2=m2)


def welford_mean(state: Welford):
    return state.mean


def welford_variance(state: Welford, ddof: int = 0):
    denom = state.count - ddof
    return _where(denom > 0, state.m2 / _where(denom > 0, denom, 1.0), 0.0)


def welford_std(state: Welford, ddof: int = 0):
    return _sqrt(welford_variance(state, ddof))


def welford_stderr(state: Welford):
    """Standard error of the running mean — the paper's sigma(q-bar)."""
    var = welford_variance(state, ddof=0)
    n = _where(state.count > 0, state.count, 1.0)
    return _sqrt(var / n)


class Moments(NamedTuple):
    """One-pass central moments up to order 4 (Pebay 2008)."""
    count: torch.Tensor
    mean: torch.Tensor
    m2: torch.Tensor
    m3: torch.Tensor
    m4: torch.Tensor


def moments_init(dtype=torch.float32, shape=(), device="cuda") -> Moments:
    """Empty moments on ``device`` (the card by default; without one this
    raises: pass ``device="cpu"`` for the host)."""
    z = torch.zeros(shape, dtype=dtype, device=resolve_device(device))
    return Moments(count=z, mean=z, m2=z, m3=z, m4=z)


def moments_update(s: Moments, x) -> Moments:
    n1 = s.count
    n = s.count + 1.0
    delta = x - s.mean
    delta_n = delta / n
    delta_n2 = delta_n * delta_n
    term1 = delta * delta_n * n1
    mean = s.mean + delta_n
    m4 = (s.m4 + term1 * delta_n2 * (n * n - 3.0 * n + 3.0)
          + 6.0 * delta_n2 * s.m2 - 4.0 * delta_n * s.m3)
    m3 = s.m3 + term1 * delta_n * (n - 2.0) - 3.0 * delta_n * s.m2
    m2 = s.m2 + term1
    return Moments(count=n, mean=mean, m2=m2, m3=m3, m4=m4)


def moments_update_batch(s: Moments, x, where=None) -> Moments:
    """Fold a whole batch of observations into the running moments with
    one vectorized evaluation: raw central moments of the batch along its
    last axis, then one exact Pebay merge.

    The last axis of ``x`` is reduced; the remaining leading shape must
    broadcast against the state's leaves, so a scalar state takes a flat
    (B,) batch and a (Q,)-leaf fleet state takes a (Q, B) tile.
    ``where`` (same shape as ``x``) masks samples out — a masked-empty
    row leaves that row's state untouched.
    """
    if isinstance(x, torch.Tensor):
        if where is None:
            n = torch.full(x.shape[:-1], float(x.shape[-1]),
                           dtype=x.dtype, device=x.device)
            mean = x.mean(dim=-1)
            d = x - mean[..., None]
        else:
            w = torch.as_tensor(where, dtype=torch.bool, device=x.device)
            n = w.sum(dim=-1).to(x.dtype)
            safe = torch.clamp(n, min=1.0)
            mean = torch.where(w, x, 0.0).sum(dim=-1) / safe
            d = torch.where(w, x - mean[..., None], 0.0)
        d2 = d * d
        batch = Moments(count=n, mean=mean, m2=d2.sum(dim=-1),
                        m3=(d2 * d).sum(dim=-1), m4=(d2 * d2).sum(dim=-1))
        return moments_merge(s, batch)
    x = np.asarray(x)
    if where is None:
        n = np.full(x.shape[:-1], float(x.shape[-1]))
        mean = np.mean(x, axis=-1)
        d = x - mean[..., None]
    else:
        w = np.asarray(where, bool)
        n = np.sum(w, axis=-1).astype(x.dtype)
        safe = np.maximum(n, 1.0)
        mean = np.sum(np.where(w, x, 0.0), axis=-1) / safe
        d = np.where(w, x - mean[..., None], 0.0)
    d2 = d * d
    batch = Moments(count=n, mean=mean,
                    m2=np.sum(d2, axis=-1),
                    m3=np.sum(d2 * d, axis=-1),
                    m4=np.sum(d2 * d2, axis=-1))
    return moments_merge(s, batch)


def moments_merge(a: Moments, b: Moments) -> Moments:
    n = a.count + b.count
    safe = _where(n > 0, n, 1.0)
    delta = b.mean - a.mean
    delta2 = delta * delta
    delta3 = delta2 * delta
    delta4 = delta2 * delta2
    na, nb = a.count, b.count
    mean = a.mean + delta * nb / safe
    m2 = a.m2 + b.m2 + delta2 * na * nb / safe
    m3 = (a.m3 + b.m3
          + delta3 * na * nb * (na - nb) / (safe * safe)
          + 3.0 * delta * (na * b.m2 - nb * a.m2) / safe)
    m4 = (a.m4 + b.m4
          + delta4 * na * nb * (na * na - na * nb + nb * nb) / (safe ** 3)
          + 6.0 * delta2 * (na * na * b.m2 + nb * nb * a.m2) / (safe * safe)
          + 4.0 * delta * (na * b.m3 - nb * a.m3) / safe)
    return Moments(count=n, mean=mean, m2=m2, m3=m3, m4=m4)


def moments_finalize(s: Moments):
    """Return (mean, variance, skewness, kurtosis_excess, cv2).

    cv2 = squared coefficient of variation of the sample — the statistic the
    distribution classifier thresholds on (exponential: cv2 ~ 1,
    deterministic: cv2 ~ 0).
    """
    n = _where(s.count > 0, s.count, 1.0)
    var = s.m2 / n
    safe_var = _where(var > 0, var, 1.0)
    skew = _where(var > 0, (s.m3 / n) / safe_var ** 1.5, 0.0)
    kurt = _where(var > 0, (s.m4 / n) / (safe_var * safe_var) - 3.0, 0.0)
    mean_sq = _where(s.mean != 0, s.mean * s.mean, 1.0)
    cv2 = _where(s.mean != 0, var / mean_sq, 0.0)
    return s.mean, var, skew, kurt, cv2
