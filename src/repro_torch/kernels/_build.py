"""Build and load one CUDA source as a shared library with a plain C
interface: ``nvcc`` at first use, ``ctypes`` to bind.

The library lands in ``build/repro_torch/`` at the repository root,
named after the source and a hash of its text, the headers (``*.cuh``)
beside it and its flags, so a changed source, header or flag builds anew
and an unchanged one loads what is there.
nvcc's report (``-Xptxas -v``: registers, shared memory, spills) is kept
beside the library as ``<library>.log``; ``ptxas_report`` reads it per
kernel.  Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Sequence

__all__ = ["NvccLibrary", "COMMON_FLAGS", "ptxas_report"]

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
            text = self.source.read_bytes() + b"".join(
                h.read_bytes()
                for h in sorted(self.source.parent.glob("*.cuh")))
            digest = hashlib.sha256(text + " ".join(self.flags).encode()
                                    ).hexdigest()
            out = _build_dir() / f"lib{self.source.stem}-{digest[:16]}.so"
            if self._loaded is not None and self._loaded[0] == out:
                return out
            if not out.exists():
                out.parent.mkdir(parents=True, exist_ok=True)
                # two libraries of one process may build the same output
                tmp = out.with_suffix(
                    f".{os.getpid()}.{threading.get_ident()}.tmp")
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


def _template_args(rest: str):
    """The template arguments at the start of a mangled name's tail
    (``ILi32ELb1E13__nv_bfloat16E...`` -> ``["32", "1", "__nv_bfloat16"]``:
    int and bool literals, type letters, length-prefixed type names), or
    None where there are none or they do not parse."""
    if not rest.startswith("I"):
        return None
    out, i = [], 1
    while i < len(rest) and rest[i] != "E":
        m = re.match(r"L[ib](-?\d+)E|([a-z])|(\d+)", rest[i:])
        if m is None:
            return None
        if m.group(3):                  # a length-prefixed type name
            start = i + m.end()
            out.append(rest[start:start + int(m.group(3))])
            i = start + int(m.group(3))
        else:
            out.append(m.group(1) or m.group(2))
            i += m.end()
    return out if i < len(rest) else None


def _kernel_name(mangled: str) -> str:
    """The last length-prefixed name of an Itanium-mangled symbol that
    names a kernel, with its template arguments (``Li128E`` -> 128,
    ``Lb1E`` -> 1, a type as it is named): ``flash_fwd_kernel<128,f>``."""
    pos, name, rest = 0, mangled, ""
    for m in re.finditer(r"\d+", mangled):
        if m.start() < pos:
            continue
        n = int(m.group())
        ident = mangled[m.end():m.end() + n]
        pos = m.end() + n
        if "kernel" in ident:
            name, rest = ident, mangled[pos:]
    args = _template_args(rest)
    if args:
        name += "<" + ",".join(args) + ">"
    return name


def ptxas_report(log: str) -> list:
    """Per kernel entry of nvcc's ``-Xptxas -v`` report: registers,
    spill stores and loads, stack frame and static shared memory, in
    bytes.  Dynamic shared memory is set at launch and is not in it."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"kernel": _kernel_name(m.group(1)), "registers": None,
                   "spill_stores": 0, "spill_loads": 0, "stack": 0,
                   "smem": 0}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = map(
                int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(sm.group(1)) if sm else 0
    return out
