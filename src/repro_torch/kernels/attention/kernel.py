"""Hopper CUDA flash-attention forward: build, binding and wrapper.

The kernel is ``csrc/attention.cu`` (see the note there for what it
replaces, what bounds it on the card and what its design does about
that).  It is compiled at first use with ``nvcc`` into a shared library
with a plain C interface (``build/repro_torch/``, keyed by a hash of the
source and flags) and bound with ``ctypes``.  ``flash_attention``
launches on ``torch.cuda.current_stream()`` and counts its launches in
``flash_attention.launches``.  On CPU tensors it runs the plain PyTorch
version from ``ref.py``; on CUDA tensors it launches the kernel or
raises — it never falls back.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels._build import COMMON_FLAGS, NvccLibrary
from repro_torch.kernels.attention.ref import attention_ref

__all__ = ["flash_attention", "build", "launch_counts",
           "reset_launch_counts", "SOURCE", "NVCC_FLAGS", "HEAD_DIMS"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "attention.cu"
NVCC_FLAGS = COMMON_FLAGS
HEAD_DIMS = (16, 32, 64, 128)

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _bind(lib: ctypes.CDLL) -> None:
    lib.repro_flash_attention.argtypes = ([_VP] * 4 + [_I] * 8
                                          + [_F, _VP])
    lib.repro_flash_attention.restype = _I
    lib.repro_flash_attention_supported.argtypes = [_I]
    lib.repro_flash_attention_supported.restype = _I


_LIBRARY = NvccLibrary(SOURCE, NVCC_FLAGS, _bind)
_COUNT_LOCK = threading.Lock()   # serve workers launch from several threads


def build() -> Path:
    """Compile the kernel (once per source/flags hash) and load it.
    Returns the shared library's path; ``<path>.log`` holds nvcc's
    ``-Xptxas -v`` report."""
    return _LIBRARY.build()


def flash_attention(q, k, v, *, causal: bool = True, scale=None):
    """q: (B,S,H,hd), k/v: (B,T,K,hd) with H % K == 0, all f32 or all
    bf16 -> (B,S,H,hd) float32.  ``scale`` defaults to hd ** -0.5."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be 4-d: (B,S,H,hd), (B,T,K,hd)")
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    if (k.shape[0] != B or k.shape[3] != hd or tuple(v.shape) != tuple(
            k.shape) or K == 0 or H % K):
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    scale = float(scale) if scale is not None else hd ** -0.5
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention takes f32 or bf16, not {q.dtype}")
    if hd not in HEAD_DIMS:
        raise NotImplementedError(f"no kernel instance for head_dim {hd} "
                                  f"(have {HEAD_DIMS})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty((B, S, H, hd), dtype=torch.float32, device=q.device)
    if out.numel() == 0 or T == 0:
        return out.zero_()
    lib = _LIBRARY.lib()
    with torch.cuda.device(q.device):
        rc = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, T, H, K, hd, int(q.dtype == torch.bfloat16), int(causal),
            scale, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    with _COUNT_LOCK:
        flash_attention.launches += 1
    return out


flash_attention.launches = 0


def launch_counts() -> dict:
    """Launches since the last ``reset_launch_counts``."""
    return {"flash_attention": flash_attention.launches}


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        flash_attention.launches = 0
