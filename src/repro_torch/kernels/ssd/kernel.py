"""Hopper CUDA SSD intra-chunk step and its backward: build, binding and
wrappers.

The kernels are ``csrc/ssd.cu`` (the forward) and ``csrc/ssd_bwd.cu``
(the backward; see the notes there for what each replaces, what bounds
it on the card and what its design does about that).  Each is compiled
at first use with ``nvcc`` into a shared library with a plain C
interface (``build/repro_torch/``, keyed by a hash of the source and
flags) and bound with ``ctypes``.  ``ssd_chunk`` and ``ssd_chunk_bwd``
launch on ``torch.cuda.current_stream()`` and count their launches in
``ssd_chunk.launches`` and ``ssd_chunk_bwd.launches``.  On CPU tensors
they run the plain PyTorch versions from ``ref.py``; on CUDA tensors
they launch the kernel or raise — they never fall back.  A gradient goes
through ``ops.SSDChunkFn``: called outside it, ``ssd_chunk`` raises on
the card when grad mode is on and an input requires grad, rather than
cut the gradient.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels._build import COMMON_FLAGS, NvccLibrary
from repro_torch.kernels.ssd.ref import (ssd_chunk_batched_ref,
                                        ssd_chunk_bwd_ref)

__all__ = ["ssd_chunk", "ssd_chunk_bwd", "build", "build_bwd",
           "launch_counts", "reset_launch_counts", "SOURCE", "SOURCE_BWD",
           "NVCC_FLAGS", "HEAD_DIMS", "MAX_CHUNK"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd.cu"
SOURCE_BWD = SOURCE.with_name("ssd_bwd.cu")
NVCC_FLAGS = COMMON_FLAGS
HEAD_DIMS = (8, 16, 32, 64)      # P, the SSD head dim
MAX_CHUNK = 256                  # Q

_VP, _I = ctypes.c_void_p, ctypes.c_int


def _bind(lib: ctypes.CDLL) -> None:
    lib.repro_ssd_chunk.argtypes = [_VP] * 8 + [_I] * 5 + [_VP]
    lib.repro_ssd_chunk.restype = _I


def _bind_bwd(lib: ctypes.CDLL) -> None:
    lib.repro_ssd_chunk_bwd.argtypes = [_VP] * 14 + [_I] * 5 + [_VP]
    lib.repro_ssd_chunk_bwd.restype = _I
    lib.repro_ssd_chunk_bwd_scratch.argtypes = [_I] * 4
    lib.repro_ssd_chunk_bwd_scratch.restype = ctypes.c_size_t


_LIBRARY = NvccLibrary(SOURCE, NVCC_FLAGS, _bind)
_LIBRARY_BWD = NvccLibrary(SOURCE_BWD, NVCC_FLAGS, _bind_bwd)
_COUNT_LOCK = threading.Lock()   # serve workers launch from several threads


def build() -> Path:
    """Compile the forward kernel (once per source/flags hash) and load
    it.  Returns the shared library's path; ``<path>.log`` holds nvcc's
    ``-Xptxas -v`` report."""
    return _LIBRARY.build()


def build_bwd() -> Path:
    """``build`` for the backward kernel."""
    return _LIBRARY_BWD.build()


def _check_shapes(x, dt, A, Bm, Cm):
    if x.dim() != 5:
        raise ValueError(f"x must be (B,c,Q,H,P), got {tuple(x.shape)}")
    B, c, Q, H, P = x.shape
    N = Bm.shape[-1] if Bm.dim() == 4 else -1
    if (tuple(dt.shape) != (B, c, Q, H) or tuple(A.shape) != (H,)
            or tuple(Bm.shape) != (B, c, Q, N)
            or tuple(Cm.shape) != (B, c, Q, N)):
        raise ValueError(
            f"bad shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
            f"{tuple(A.shape)}, B {tuple(Bm.shape)}, C {tuple(Cm.shape)}")
    return B, c, Q, H, P, N


def _check_card(what, ins, x, P, Q, N, B, c):
    """The card kernels' checks; returns the inputs as contiguous,
    16-byte aligned float32."""
    for name, t in ins.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{what} takes f32 or bf16, {name} is "
                            f"{t.dtype}")
    if P not in HEAD_DIMS:
        raise NotImplementedError(f"no kernel instance for head dim {P} "
                                  f"(have {HEAD_DIMS})")
    if not 1 <= Q <= MAX_CHUNK or N < 4 or N % 4:
        raise NotImplementedError(
            f"the kernel takes chunks of 1..{MAX_CHUNK} rows and a state "
            f"width that is a multiple of 4, not Q {Q}, N {N}")
    if B * c > 65535:
        raise ValueError(f"batch x chunks {B * c} exceeds the grid's 65535")
    ins = {n: t.float() for n, t in ins.items()}
    for name, t in ins.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return ins


def ssd_chunk(x, dt, A, Bm, Cm):
    """Intra-chunk SSD for every (batch, chunk, head).

    x: (B,c,Q,H,P) dt: (B,c,Q,H) A: (H,) Bm/Cm: (B,c,Q,N), float32 or
    bf16 (cast to float32 first, as the Pallas wrapper casts)
    -> (y_intra (B,c,Q,H,P), sstate (B,c,H,P,N), decay (B,c,H)), float32.
    """
    B, c, Q, H, P, N = _check_shapes(x, dt, A, Bm, Cm)
    if x.device.type == "cpu":
        return ssd_chunk_batched_ref(x, dt, A, Bm, Cm)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk runs on cuda or cpu, not {x.device}")
    ins = {"x": x, "dt": dt, "A": A, "B": Bm, "C": Cm}
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in ins.values()):
        raise RuntimeError(
            "ssd_chunk's kernel called with grad outside SSDChunkFn would "
            "give the mamba projections no gradient: differentiate through "
            "kernels.ssd.ops.SSDChunkFn (ssd_chunked does so under grad)")
    ins = _check_card("ssd_chunk", ins, x, P, Q, N, B, c)
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((B, c, Q, H, P), **f32)
    state = torch.empty((B, c, H, P, N), **f32)
    decay = torch.empty((B, c, H), **f32)
    if y.numel() == 0:
        return y, state, decay
    lib = _LIBRARY.lib()
    with torch.cuda.device(x.device):
        rc = lib.repro_ssd_chunk(
            ins["x"].data_ptr(), ins["dt"].data_ptr(), ins["A"].data_ptr(),
            ins["B"].data_ptr(), ins["C"].data_ptr(), y.data_ptr(),
            state.data_ptr(), decay.data_ptr(), B * c, Q, H, P, N,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_chunk launch failed: CUDA error {rc}")
    with _COUNT_LOCK:
        ssd_chunk.launches += 1
    return y, state, decay


ssd_chunk.launches = 0


def ssd_chunk_bwd(x, dt, A, Bm, Cm, dy=None, dstate=None, ddecay=None):
    """The backward of ``ssd_chunk``: the inputs as ``ssd_chunk`` takes
    them and the cotangents dy (B,c,Q,H,P), dstate (B,c,H,P,N) and
    ddecay (B,c,H) of its outputs (None counts as zeros) -> (dx
    (B,c,Q,H,P), ddt (B,c,Q,H), dA (H,), dB, dC (B,c,Q,N)), float32."""
    B, c, Q, H, P, N = _check_shapes(x, dt, A, Bm, Cm)
    cots = {"dy": (dy, (B, c, Q, H, P)), "dstate": (dstate, (B, c, H, P, N)),
            "ddecay": (ddecay, (B, c, H))}
    for name, (t, shape) in cots.items():
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if x.device.type == "cpu":
        return ssd_chunk_bwd_ref(x, dt, A, Bm, Cm, dy, dstate, ddecay)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk_bwd runs on cuda or cpu, not {x.device}")
    ins = {"x": x, "dt": dt, "A": A, "B": Bm, "C": Cm}
    for name, (t, shape) in cots.items():
        ins[name] = (torch.zeros(shape, dtype=torch.float32, device=x.device)
                     if t is None else t)
    ins = _check_card("ssd_chunk_bwd", ins, x, P, Q, N, B, c)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((B, c, Q, H, P), **f32)
    ddt = torch.empty((B, c, Q, H), **f32)
    dA = torch.empty((H,), **f32)
    dB = torch.empty((B, c, Q, N), **f32)
    dC = torch.empty((B, c, Q, N), **f32)
    if dx.numel() == 0:
        return dx, ddt, dA.zero_(), dB.zero_(), dC.zero_()
    lib = _LIBRARY_BWD.lib()
    scratch = torch.empty(lib.repro_ssd_chunk_bwd_scratch(B * c, Q, H, N),
                          **f32)
    with torch.cuda.device(x.device):
        rc = lib.repro_ssd_chunk_bwd(
            *(ins[n].data_ptr() for n in ("x", "dt", "A", "B", "C", "dy",
                                          "dstate", "ddecay")),
            dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), scratch.data_ptr(), B * c, Q, H, P, N,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_chunk_bwd launch failed: CUDA error {rc}")
    with _COUNT_LOCK:
        ssd_chunk_bwd.launches += 1
    return dx, ddt, dA, dB, dC


ssd_chunk_bwd.launches = 0


def launch_counts() -> dict:
    """Launches since the last ``reset_launch_counts``."""
    return {"ssd_chunk": ssd_chunk.launches,
            "ssd_chunk_bwd": ssd_chunk_bwd.launches}


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        ssd_chunk.launches = 0
        ssd_chunk_bwd.launches = 0
