"""Discrete filters from the paper (Eq. 2 and Eq. 4).

The paper de-noises the sliding window of non-blocking transaction counts
with a discrete Gaussian filter of radius 2 (Eq. 2), and judges convergence
of the running estimate by convolving the sigma(q-bar) trace with a
Laplacian-of-Gaussian filter of radius 1, sigma = 1/2 (Eq. 4).

Both filters are evaluated in *valid* mode ("padding is not used ... the
result of the filter has a width 2*radius smaller than the data window").

The taps are numpy float64 arrays.  ``convolve_valid`` and the filters
run on torch tensors (any device) and on plain numpy arrays alike — the
host-side monitor threads use float64 numpy through the same functions.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

__all__ = [
    "gaussian_kernel",
    "log_kernel",
    "gaussian_taps",
    "log_taps",
    "convolve_valid",
    "gaussian_filter_valid",
    "log_filter_valid",
]


def gaussian_kernel(radius: int = 2, sigma: float = 1.0, *,
                    normalize: bool = True) -> np.ndarray:
    """Discrete Gaussian kernel, paper Eq. 2.

    Eq. 2 is the raw pdf ``exp(-x^2/2) / sqrt(2*pi)`` sampled at the integer
    offsets ``x in [-radius, radius]``.  The raw 5-tap kernel sums to ~0.9913,
    which would bias every filtered count low by ~0.9%; ``normalize=True``
    (default) rescales to unit sum.  ``normalize=False`` reproduces Eq. 2
    verbatim for the paper-faithful tests.
    """
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(x ** 2) / (2.0 * sigma ** 2)) / (math.sqrt(2.0 * math.pi) * sigma)
    if normalize:
        k = k / k.sum()
    return k


def log_kernel(radius: int = 1, sigma: float = 0.5) -> np.ndarray:
    """Laplacian-of-Gaussian kernel, paper Eq. 4 (radius 1, sigma = 1/2).

    LoG(x) = x^2 e^{-x^2/(2 s^2)} / (sqrt(2 pi) s^5) - e^{-x^2/(2 s^2)} / (sqrt(2 pi) s^3)

    This is the second derivative of the Gaussian; its response over a trace
    measures the local rate of change, which the paper drives toward zero to
    declare convergence of q-bar.
    """
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2)) / math.sqrt(2.0 * math.pi)
    return (x ** 2) * g / sigma ** 5 - g / sigma ** 3


def convolve_valid(x, kernel):
    """Valid-mode correlation of a 1-D signal with a (symmetric) kernel.

    Output length = len(x) - len(kernel) + 1 = len(x) - 2*radius.
    Implemented as a stack of shifted slices over the last axis, so it
    batches over leading axes.  Works for torch tensors (in their own
    dtype and device) and numpy inputs alike.
    """
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    taps = len(kernel)
    n_out = x.shape[-1] - taps + 1
    if n_out <= 0:
        raise ValueError(
            f"signal length {x.shape[-1]} shorter than kernel length {taps}")
    if isinstance(x, torch.Tensor):
        # a python-float tap is rounded to the tensor's compute type
        taps_x = [float(k) for k in kernel]
    else:
        taps_x = [np.asarray(k, dtype=x.dtype) for k in kernel]
    acc = x[..., 0:n_out] * taps_x[0]
    for i in range(1, taps):
        acc = acc + x[..., i:i + n_out] * taps_x[i]
    return acc


@functools.lru_cache(maxsize=None)
def gaussian_taps(radius: int = 2, sigma: float = 1.0,
                  normalize: bool = True) -> tuple:
    """Eq. 2 kernel as a cached tuple of python floats (hashable — usable
    as static kernel parameters and cheap to splat into stencils)."""
    return tuple(gaussian_kernel(radius, sigma, normalize=normalize)
                 .tolist())


@functools.lru_cache(maxsize=None)
def log_taps(radius: int = 1, sigma: float = 0.5) -> tuple:
    """Eq. 4 LoG kernel as a cached tuple of python floats."""
    return tuple(log_kernel(radius, sigma).tolist())


def gaussian_filter_valid(x, radius: int = 2, sigma: float = 1.0, *,
                          normalize: bool = True):
    """S -> S' of Algorithm 1: valid-mode Gaussian smoothing of the window."""
    return convolve_valid(x, gaussian_taps(radius, float(sigma), normalize))


def log_filter_valid(x, radius: int = 1, sigma: float = 0.5):
    """The paper's combined Gaussian+Laplacian ('one combined filter is
    used') applied in valid mode to the sigma(q-bar) trace."""
    return convolve_valid(x, log_taps(radius, float(sigma)))
