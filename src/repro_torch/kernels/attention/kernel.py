"""Hopper CUDA flash attention, forward and backward: build, binding and
wrappers.

The kernels are in ``csrc/attention.cu`` (forward) and
``csrc/attention_bwd.cu`` (backward; see the notes there for what they
replace, what bounds them on the card and what their designs do about
that): bf16 inputs run on the tensor cores, float32 inputs on the CUDA
cores.  Each source is compiled at first use with ``nvcc`` into a shared
library with a plain C interface (``build/repro_torch/``, keyed by a
hash of the source and flags) and bound with ``ctypes``.  The wrappers
launch on ``torch.cuda.current_stream()`` and count their launches in
``flash_attention.launches`` and ``flash_attention_bwd.launches``.  On
CPU tensors they run the plain PyTorch versions from ``ref.py``; on
CUDA tensors they launch the kernel or raise — they never fall back.

Both have instances at every head dim of ``HEAD_DIMS``, each with an attention-logit
softcap and a sliding window as launch arguments.  On the card both
refuse a window that leaves a row with no key (S >= T + window), where
the reference's uniform softmax gives the mean of v and the kernels
would give 0 (``require_bwd_instance``; ROADMAP.md, reference caveats);
on the CPU the plain versions take every case.

The kernels have no autograd history: on the card, ``flash_attention``
raises when grad mode is on and an input requires grad, since its
output would silently cut the gradient to q, k and v.  The training path
goes through ``ops.FlashAttentionFn``, whose backward is
``flash_attention_bwd``.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels._build import COMMON_FLAGS, NvccLibrary
from repro_torch.kernels.attention.ref import (attention_bwd_ref,
                                               attention_lse_ref,
                                               attention_ref)

__all__ = ["flash_attention", "flash_attention_bwd", "build", "build_bwd",
           "launch_counts", "reset_launch_counts", "shared_memory_bytes",
           "shared_memory_bytes_bwd", "SOURCE", "SOURCE_BWD", "NVCC_FLAGS",
           "HEAD_DIMS", "require_bwd_instance"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "attention.cu"
SOURCE_BWD = Path(__file__).resolve().parent / "csrc" / "attention_bwd.cu"
NVCC_FLAGS = COMMON_FLAGS
HEAD_DIMS = (16, 32, 64, 112, 128, 256)
BWD_ROW_PAD = 128    # tc::ROW_PAD in attention_bwd.cu

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _bind(lib: ctypes.CDLL) -> None:
    lib.repro_flash_attention.argtypes = ([_VP] * 5 + [_I] * 8
                                          + [_F, _F, _I, _VP])
    lib.repro_flash_attention.restype = _I
    lib.repro_flash_attention_supported.argtypes = [_I]
    lib.repro_flash_attention_supported.restype = _I
    lib.repro_flash_attention_smem.argtypes = [_I, _I]
    lib.repro_flash_attention_smem.restype = _I


def _bind_bwd(lib: ctypes.CDLL) -> None:
    lib.repro_flash_attention_bwd.argtypes = ([_VP] * 11 + [_I] * 8
                                              + [_F, _F, _I, _VP])
    lib.repro_flash_attention_bwd.restype = _I
    lib.repro_flash_attention_bwd_smem.argtypes = [_I, _I]
    lib.repro_flash_attention_bwd_smem.restype = _I


_LIBRARY = NvccLibrary(SOURCE, NVCC_FLAGS, _bind)
_LIBRARY_BWD = NvccLibrary(SOURCE_BWD, NVCC_FLAGS, _bind_bwd)
_COUNT_LOCK = threading.Lock()   # serve workers launch from several threads


def build() -> Path:
    """Compile the forward kernel (once per source/flags hash) and load
    it.  Returns the shared library's path; ``<path>.log`` holds nvcc's
    ``-Xptxas -v`` report."""
    return _LIBRARY.build()


def build_bwd() -> Path:
    """The same for the backward kernel."""
    return _LIBRARY_BWD.build()


def shared_memory_bytes(hd: int, dtype) -> int:
    """Dynamic shared memory of the forward kernel instance for ``hd``
    and the input type, in bytes (builds the library; ptxas's report
    does not hold it, as it is set at launch)."""
    return _LIBRARY.lib().repro_flash_attention_smem(
        hd, int(dtype == torch.bfloat16))


def shared_memory_bytes_bwd(hd: int, dtype) -> int:
    """The same for the backward kernels' instance."""
    return _LIBRARY_BWD.lib().repro_flash_attention_bwd_smem(
        hd, int(dtype == torch.bfloat16))


def _check(q, k, v):
    """Shapes -> (B, S, T, H, K, hd)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be 4-d: (B,S,H,hd), (B,T,K,hd)")
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    if (k.shape[0] != B or k.shape[3] != hd or tuple(v.shape) != tuple(
            k.shape) or K == 0 or H % K):
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    return B, S, T, H, K, hd


def _check_card(name, q, tensors, dtypes):
    """Device, type, head-dim and layout checks of a launch on the card;
    ``tensors`` maps names to (tensor, allowed dtypes or None for q's)."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {q.device}")
    if q.dtype not in dtypes:
        raise TypeError(f"{name} takes f32 or bf16, not {q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise NotImplementedError(f"no kernel instance for head_dim "
                                  f"{q.shape[-1]} (have {HEAD_DIMS})")
    for tname, (t, want) in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{tname} is on {t.device}, q on {q.device}")
        if t.dtype != (want or q.dtype):
            raise TypeError(f"{tname} is {t.dtype}, expected "
                            f"{want or q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{tname} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{tname} must be 16-byte aligned")


def _count(fn) -> None:
    with _COUNT_LOCK:
        fn.launches += 1


def _no_key_rows(S: int, T: int, window: int) -> bool:
    """A window that leaves the rows from T + window - 1 on with no key."""
    return window > 0 and S >= T + window


def _no_key_message(name, S, T, window):
    return (f"{name} at S {S}, T {T}, window {window}: rows from "
            f"{T + window - 1} on keep no key, where the reference's "
            "uniform softmax gives the mean of v and the kernel would give "
            "0; the kernel takes no such call (ROADMAP.md, reference "
            "caveats)")


def require_bwd_instance(hd: int, S: int, T: int, window: int = 0) -> None:
    """Raise ``NotImplementedError`` where the backward kernel takes no
    call, as the forward's wrapper refuses it: a head dim outside
    ``HEAD_DIMS``, or a window that leaves a row with no key (S >= T
    + window)."""
    if hd not in HEAD_DIMS:
        raise NotImplementedError(
            f"flash_attention_bwd has no kernel instance for head_dim {hd} "
            f"(have {HEAD_DIMS}; ROADMAP.md)")
    if _no_key_rows(S, T, int(window or 0)):
        raise NotImplementedError(_no_key_message(
            "flash_attention_bwd", S, T, window))


def flash_attention(q, k, v, *, causal: bool = True, scale=None,
                    softcap=None, window: int = 0,
                    return_lse: bool = False):
    """q: (B,S,H,hd), k/v: (B,T,K,hd) with H % K == 0, all f32 or all
    bf16 -> (B,S,H,hd) float32.  ``scale`` defaults to hd ** -0.5;
    ``softcap`` (None or 0: none) caps the scaled scores at
    softcap tanh(s / softcap); ``window`` > 0 masks the keys at or before
    q - window (``ref.attention_ref``).  On the card a call whose window
    leaves a row with no key (S >= T + window) raises
    ``NotImplementedError``.

    With ``return_lse`` also each row's log-sum-exp in base 2, (B,H,S)
    float32 (``ref.attention_lse_ref``), which ``flash_attention_bwd``
    reads.  On the card this raises if grad mode is on and an input
    requires grad: use ``ops.flash_attention``, which differentiates
    through ``ops.FlashAttentionFn``."""
    B, S, T, H, K, hd = _check(q, k, v)
    scale = float(scale) if scale is not None else hd ** -0.5
    softcap, window = float(softcap or 0.0), int(window or 0)
    if q.device.type == "cpu":
        kw = dict(causal=causal, scale=scale, softcap=softcap, window=window)
        out = attention_ref(q, k, v, **kw)
        if return_lse:
            return out, attention_lse_ref(q, k, **kw)
        return out
    _check_card("flash_attention", q,
                {"q": (q, None), "k": (k, None), "v": (v, None)},
                (torch.float32, torch.bfloat16))
    if _no_key_rows(S, T, window):
        raise NotImplementedError(_no_key_message("flash_attention", S, T,
                                                  window))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_attention's kernel has no autograd history, so a loss "
            "through it would give q, k and v no gradient: differentiate "
            "through kernels.attention.ops.flash_attention "
            "(FlashAttentionFn), or call it under torch.no_grad()")
    out = torch.empty((B, S, H, hd), dtype=torch.float32, device=q.device)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0 or T == 0:
        out.zero_()
        if lse is not None:
            lse.fill_(float("inf"))      # no key: P = 0 in the backward
        return (out, lse) if return_lse else out
    lib = _LIBRARY.lib()
    with torch.cuda.device(q.device):
        rc = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            B, S, T, H, K, hd, int(q.dtype == torch.bfloat16), int(causal),
            scale, softcap, window,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    _count(flash_attention)
    return (out, lse) if return_lse else out


flash_attention.launches = 0


def flash_attention_bwd(q, k, v, o, do, lse, *, causal: bool = True,
                        scale=None, softcap=None, window: int = 0):
    """The gradients of ``flash_attention``'s output ``o`` (B,S,H,hd)
    under ``do`` (B,S,H,hd): q (B,S,H,hd), k/v (B,T,K,hd) as the forward
    took them, o, do and the forward's ``lse`` (B,H,S) float32 ->
    (dq, dk, dv) float32 in q's, k's and v's shapes; ``causal``,
    ``scale``, ``softcap`` and ``window`` as the forward took them.  On
    CPU tensors the plain version, which recomputes the softmax and
    ignores ``lse``; on the card ``require_bwd_instance`` raises for a
    call the kernel does not take."""
    B, S, T, H, K, hd = _check(q, k, v)
    for name, t, shape in (("o", o, q.shape), ("do", do, q.shape),
                           ("lse", lse, (B, H, S))):
        if t is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} is {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
    scale = float(scale) if scale is not None else hd ** -0.5
    softcap, window = float(softcap or 0.0), int(window or 0)
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, o, do, causal=causal, scale=scale,
                                 softcap=softcap, window=window)
    require_bwd_instance(hd, S, T, window)
    f32 = torch.float32
    _check_card("flash_attention_bwd", q,
                {"q": (q, None), "k": (k, None), "v": (v, None),
                 "o": (o, f32), "do": (do, f32), "lse": (lse, f32)},
                (f32, torch.bfloat16))
    dev = q.device
    dq = torch.empty((B, S, H, hd), dtype=f32, device=dev)
    dk = torch.empty((B, T, K, hd), dtype=f32, device=dev)
    dv = torch.empty((B, T, K, hd), dtype=f32, device=dev)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    is_bf16 = q.dtype == torch.bfloat16
    # scratch: D (B,H,S) for f32; for bf16 lse and D with rows padded to
    # a multiple of BWD_ROW_PAD, and dO rounded to bf16
    if is_bf16:
        delta = torch.empty((2, B, H, -(-S // BWD_ROW_PAD) * BWD_ROW_PAD),
                            dtype=f32, device=dev)
        dob = torch.empty((B, S, H, hd), dtype=torch.bfloat16, device=dev)
    else:
        delta, dob = torch.empty((B, H, S), dtype=f32, device=dev), None
    lib = _LIBRARY_BWD.lib()
    with torch.cuda.device(dev):
        rc = lib.repro_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(),
            dob.data_ptr() if dob is not None else None,
            B, S, T, H, K, hd, int(is_bf16), int(causal), scale, softcap,
            window, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error "
                           f"{rc}")
    _count(flash_attention_bwd)
    return dq, dk, dv


flash_attention_bwd.launches = 0


def launch_counts() -> dict:
    """Launches since the last ``reset_launch_counts``."""
    return {"flash_attention": flash_attention.launches,
            "flash_attention_bwd": flash_attention_bwd.launches}


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        flash_attention.launches = 0
        flash_attention_bwd.launches = 0
