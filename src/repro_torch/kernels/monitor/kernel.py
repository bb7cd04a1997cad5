"""Hopper CUDA kernels of the fleet monitor: build, binding and wrappers.

Two kernels, both in ``csrc/monitor.cu`` (see the note there for what
each replaces, what bounds it on the card and what its design does
about that):

* ``monitor_fleet`` — the fused time-batched Algorithm-1 scan over a
  compacted (Q, T) tile, updating the fleet state in place.
* ``batched_monitor`` — the per-tick window stage (Eq. 2+3) over (Q, w)
  windows.

The source is compiled at first use with ``nvcc`` into a shared library
with a plain C interface (``build/repro_torch/`` at the repository root,
keyed by a hash of the source and flags) and bound with ``ctypes``.
Each wrapper launches on ``torch.cuda.current_stream()`` and counts its
launches in ``<wrapper>.launches``.  On a CPU tensor a wrapper runs its
kernel's plain PyTorch version from ``ref.py`` instead; on a CUDA tensor
it launches the kernel or raises — it never falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.filters import gaussian_kernel
from repro_torch.core.monitor import FleetMonitorState, MonitorConfig, Z_95
from repro_torch.kernels.monitor.ref import (batched_monitor_ref,
                                             carry_of_state,
                                             fleet_static_params,
                                             monitor_fleet_ref, window_carry)

__all__ = ["monitor_fleet", "batched_monitor", "build", "reset_launch_counts",
           "launch_counts", "SOURCE", "NVCC_FLAGS"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "monitor.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")


def _build_dir() -> Path:
    # src/repro_torch/kernels/monitor/kernel.py -> <repo>/build/repro_torch
    return Path(__file__).resolve().parents[4] / "build" / "repro_torch"


_LIB = None
_LIB_LOCK = threading.Lock()
_VP, _I, _F, _LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                    ctypes.c_longlong)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the monitor kernels are built from "
                       f"{SOURCE} with the CUDA toolkit")


def build() -> Path:
    """Compile the kernels (once per source/flags hash) and load them.
    Returns the shared library's path; ``<path>.log`` holds nvcc's
    ``-Xptxas -v`` report (registers, spills) of that build."""
    global _LIB
    with _LIB_LOCK:
        digest = hashlib.sha256(SOURCE.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()
        out = _build_dir() / f"libmonitor-{digest[:16]}.so"
        if _LIB is not None and _LIB[0] == out:
            return out
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            Path(str(out) + ".log").write_text(res.stdout + res.stderr)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                                   f"{res.stdout}{res.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        lib.repro_monitor_fleet.argtypes = (
            [_VP, _LL, _VP, _I, _I] + [_VP] * 16
            + [_I, _I, _I, _I, _VP, _VP, _F, _F, _F, _I, _I, _VP])
        lib.repro_monitor_fleet.restype = _I
        lib.repro_monitor_fleet_supported.argtypes = [_I, _I, _I]
        lib.repro_monitor_fleet_supported.restype = _I
        lib.repro_batched_monitor.argtypes = [_VP, _I, _I, _I, _VP, _I, _F,
                                              _VP, _VP, _VP, _VP]
        lib.repro_batched_monitor.restype = _I
        _LIB = (out, lib)
        return out


def _lib():
    if _LIB is None:
        build()
    return _LIB[1]


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


def _f32_array(values) -> ctypes.Array:
    vals = [float(np.float32(v)) for v in values]
    return (ctypes.c_float * len(vals))(*vals)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def monitor_fleet(cfg: MonitorConfig, state: FleetMonitorState, comp, m, *,
                  full: bool):
    """Fused Algorithm-1 scan over a compacted (Q, T) tile, in place.

    comp: (Q, T) f32 compacted samples (rows may be strided: unit column
    stride, row stride >= T); m: (Q,) int32 valid counts.  Updates the
    state's ``win``/``s_fill``/``count``/``mean``/``m2``/``qhist``/
    ``shist``/``rhist``/``epoch``/``last_qbar`` in place (``n_total``/
    ``n_blocked`` are the caller's) and returns the six (Q, T) output
    planes ``(q, qbar, sigma, converged, estimate, epoch)`` when
    ``full``, else None.
    """
    if comp.device.type == "cpu":
        carry, cols = monitor_fleet_ref(cfg, state, comp, m)
        state.win.copy_(window_carry(state.win, comp, m))
        for leaf, new in zip(carry_of_state(state), carry):
            leaf.copy_(new)
        return cols if full else None
    if comp.device.type != "cuda":
        raise ValueError(f"monitor_fleet runs on cuda or cpu, not "
                         f"{comp.device}")

    P = fleet_static_params(cfg)
    Q, T = comp.shape
    W, CW, R = cfg.window, cfg.conv_window, cfg.gauss_radius
    dev = comp.device
    f32, i32 = torch.float32, torch.int32
    if comp.dtype != f32 or comp.stride(1) != 1 or comp.stride(0) < T:
        raise ValueError("comp must be f32 (Q, T) with unit column stride")
    _require(m, "m", i32, (Q,), dev)
    for name, dt, shape in (("win", f32, (Q, W)), ("s_fill", i32, (Q,)),
                            ("count", f32, (Q,)), ("mean", f32, (Q,)),
                            ("m2", f32, (Q,)), ("qhist", f32, (Q, CW)),
                            ("shist", f32, (Q, 2)), ("rhist", f32, (Q, CW)),
                            ("epoch", i32, (Q,)), ("last_qbar", f32, (Q,))):
        _require(getattr(state, name), name, dt, shape, dev)
    lib = _lib()
    if not lib.repro_monitor_fleet_supported(W, CW, R):
        raise NotImplementedError(
            f"monitor_fleet kernel has no instance for window={W}, "
            f"conv_window={CW}, gauss_radius={R} (see FLEET_SHAPES in "
            f"{SOURCE.name})")
    if full:
        planes = tuple(torch.empty((Q, T), dtype=dt, device=dev)
                       for dt in (f32, f32, f32, torch.bool, f32, i32))
    else:
        planes = (None,) * 6
    ptrs = [None if p is None else p.data_ptr() for p in planes]
    gt, lt = _f32_array(P.gauss_taps), _f32_array(P.log_taps)
    with torch.cuda.device(dev):
        rc = lib.repro_monitor_fleet(
            comp.data_ptr(), comp.stride(0), m.data_ptr(), Q, T,
            state.win.data_ptr(), state.s_fill.data_ptr(),
            state.count.data_ptr(), state.mean.data_ptr(),
            state.m2.data_ptr(), state.qhist.data_ptr(),
            state.shist.data_ptr(), state.rhist.data_ptr(),
            state.epoch.data_ptr(), state.last_qbar.data_ptr(), *ptrs,
            int(full), W, CW, R, ctypes.cast(gt, _VP), ctypes.cast(lt, _VP),
            P.z, P.conv_tol, float(max(CW + 2, P.min_q)), int(P.rel_tol),
            int(P.window_std), _stream(comp))
    _check(rc, "monitor_fleet")
    monitor_fleet.launches += 1
    return planes if full else None


monitor_fleet.launches = 0


def batched_monitor(windows, *, radius: int = 2, sigma: float = 1.0,
                    z: float = Z_95):
    """(Q, w) f32 or bf16 windows -> (q, mu, sd), each (Q,) f32."""
    if windows.device.type == "cpu":
        return batched_monitor_ref(windows, radius=radius, sigma=sigma, z=z)
    if windows.device.type != "cuda":
        raise ValueError(f"batched_monitor runs on cuda or cpu, not "
                         f"{windows.device}")
    if windows.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"windows must be f32 or bf16, not {windows.dtype}")
    if windows.dim() != 2 or not windows.is_contiguous():
        raise ValueError("windows must be a contiguous (Q, w) tensor")
    Q, W = windows.shape
    taps = gaussian_kernel(radius, sigma, normalize=True)
    if W < len(taps):
        raise ValueError(f"window {W} shorter than the {len(taps)}-tap "
                         "stencil")
    outs = tuple(torch.empty((Q,), dtype=torch.float32,
                             device=windows.device) for _ in range(3))
    tp = _f32_array(taps)
    with torch.cuda.device(windows.device):
        rc = _lib().repro_batched_monitor(
            windows.data_ptr(), int(windows.dtype == torch.bfloat16), Q, W,
            ctypes.cast(tp, _VP), len(taps), float(np.float32(z)),
            outs[0].data_ptr(), outs[1].data_ptr(), outs[2].data_ptr(),
            _stream(windows))
    _check(rc, "batched_monitor")
    batched_monitor.launches += 1
    return outs


batched_monitor.launches = 0


def launch_counts() -> dict:
    """Launches of each kernel since the last ``reset_launch_counts``."""
    return {"monitor_fleet": monitor_fleet.launches,
            "batched_monitor": batched_monitor.launches}


def reset_launch_counts() -> None:
    monitor_fleet.launches = 0
    batched_monitor.launches = 0
