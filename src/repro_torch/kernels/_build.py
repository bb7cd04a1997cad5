"""Build and load one CUDA source as a shared library with a plain C
interface: ``nvcc`` at first use, ``ctypes`` to bind.

The library lands in ``build/repro_torch/`` at the repository root,
named after the source and a hash of its text and flags, so a changed
source or flag builds anew and an unchanged one loads what is there.
nvcc's report (``-Xptxas -v``: registers, shared memory, spills) is kept
beside the library as ``<library>.log``.  Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Sequence

__all__ = ["NvccLibrary", "COMMON_FLAGS"]

# sm_90a: the Hopper target with wgmma/setmaxnreg (plain sm_90 refuses them)
COMMON_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")


def _build_dir() -> Path:
    # src/repro_torch/kernels/_build.py -> <repo>/build/repro_torch
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's kernels are built with "
                       "the CUDA toolkit")


class NvccLibrary:
    """One ``.cu`` source, its nvcc flags and its ctypes signatures.

    ``bind(lib)`` sets ``argtypes``/``restype`` on the loaded library.
    ``build()`` compiles (once per source-and-flags hash), loads and
    binds; ``lib()`` returns the bound library, building it first if
    needed.  Thread-safe: concurrent first calls build once.
    """

    def __init__(self, source: Path, flags: Sequence[str],
                 bind: Callable[[ctypes.CDLL], None]):
        self.source = Path(source)
        self.flags = tuple(flags)
        self._bind = bind
        self._lock = threading.Lock()
        self._loaded = None            # (path, CDLL)

    def build(self) -> Path:
        """Compile and load the library; returns its path."""
        with self._lock:
            digest = hashlib.sha256(self.source.read_bytes()
                                    + " ".join(self.flags).encode()
                                    ).hexdigest()
            out = _build_dir() / f"lib{self.source.stem}-{digest[:16]}.so"
            if self._loaded is not None and self._loaded[0] == out:
                return out
            if not out.exists():
                out.parent.mkdir(parents=True, exist_ok=True)
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                cmd = [_nvcc(), *self.flags, "-o", str(tmp),
                       str(self.source)]
                res = subprocess.run(cmd, capture_output=True, text=True)
                Path(str(out) + ".log").write_text(res.stdout + res.stderr)
                if res.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed on {self.source.name} "
                        f"({res.returncode}):\n{res.stdout}{res.stderr}")
                os.replace(tmp, out)
            lib = ctypes.CDLL(str(out))
            self._bind(lib)
            self._loaded = (out, lib)
            return out

    def lib(self) -> ctypes.CDLL:
        if self._loaded is None:
            self.build()
        return self._loaded[1]
