"""Asynchronous, atomic checkpointing with auto-resume.

Layout (the JAX package's, so a checkpoint written by either package
restores in the other): ``<dir>/step_<N>/leaf_<i>.npy`` and
``manifest.json`` (step, per-leaf shape, dtype and crc32 of the bytes,
and the tree's key paths).  Leaves are numbered in ``jax.tree_util``'s
order for nested dicts: sorted keys, depth first.  Writes go to a tmp
dir and are renamed into place (atomic commit); a crash mid-write never
corrupts the latest valid checkpoint.  Saves run on a background thread
so the train loop only pays the device-to-host copy.

numpy has no bfloat16: a bf16 tensor is written as its float32 values
(exact), and restored into the like-state's bf16.  A bf16 leaf written
by the JAX package (``ml_dtypes``' bfloat16, which numpy loads as raw
2-byte values) is read back from its raw bytes.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import threading
import zlib
from typing import Optional

import numpy as np
import torch

__all__ = ["CheckpointManager"]


def _flatten(tree, path=()) -> tuple[list, list]:
    """(leaves, key paths) of nested dicts, sorted keys, depth first."""
    if not isinstance(tree, dict):
        return [tree], ["/".join(path)]
    leaves, paths = [], []
    for k in sorted(tree):
        lv, ps = _flatten(tree[k], path + (str(k),))
        leaves += lv
        paths += ps
    return leaves, paths


def _unflatten(like, leaves: list):
    """``leaves`` (in ``_flatten`` order) in the structure of ``like``."""
    it = iter(leaves)

    def build(node):
        if not isinstance(node, dict):
            return next(it)
        out = {k: build(node[k]) for k in sorted(node)}
        return {k: out[k] for k in node}           # like's own key order
    return build(like)


def _to_host(x) -> np.ndarray:
    """A host copy of a leaf that nothing else aliases: the writer thread
    reads it while the train loop updates the state in place (a CPU
    tensor's ``.numpy()`` is a view of its live memory)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.float().cpu().numpy()          # .float() copies
        return x.cpu().numpy().copy()
    return np.array(x)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xffffffff


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._lock = threading.Lock()
        self._pending: Optional[threading.Thread] = None

    # ---------------- save ------------------------------------------------
    def save(self, step: int, state, *, blocking: bool = False):
        leaves, paths = _flatten(state)
        host_leaves = [_to_host(x) for x in leaves]   # device->host now
        t = threading.Thread(target=self._write, daemon=True,
                             args=(step, host_leaves, paths))
        self.wait()
        self._pending = t
        t.start()
        if blocking:
            self.wait()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _write(self, step: int, leaves: list, paths: list):
        with self._lock:
            tmp = self.dir / f".tmp_step_{step}"
            final = self.dir / f"step_{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            manifest = {"step": step, "leaves": []}
            for i, leaf in enumerate(leaves):
                np.save(tmp / f"leaf_{i}.npy", leaf)
                manifest["leaves"].append({
                    "i": i, "shape": list(leaf.shape),
                    "dtype": str(leaf.dtype), "crc32": _crc(leaf)})
            manifest["treedef"] = str(paths)
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)                       # atomic commit
            self._gc()

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # ---------------- restore ---------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "manifest.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, like_state, step: Optional[int] = None,
                *, verify: bool = True):
        """Restore into the structure of ``like_state`` (shapes checked).
        A tensor leaf of ``like_state`` gives a tensor on its device and in
        its dtype; any other leaf a numpy array, as written.  Returns
        (state, step) or (None, None) when no checkpoint exists."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        leaves, _ = _flatten(like_state)
        if len(leaves) != len(manifest["leaves"]):
            raise ValueError("checkpoint/state structure mismatch")
        out = []
        for i, ref in enumerate(leaves):
            arr = np.load(d / f"leaf_{i}.npy")
            meta = manifest["leaves"][i]
            if verify and _crc(arr) != meta["crc32"]:
                raise IOError(f"checkpoint leaf {i} corrupt "
                              f"(crc mismatch) at step {step}")
            want = tuple(getattr(ref, "shape", arr.shape))
            if tuple(arr.shape) != want:
                raise ValueError(f"leaf {i} shape {arr.shape} != {want}")
            if isinstance(ref, torch.Tensor):
                if meta["dtype"] == "bfloat16":     # raw bf16 bits
                    t = torch.from_numpy(arr.view(np.int16).copy()).view(
                        torch.bfloat16)
                else:
                    t = torch.from_numpy(arr)
                arr = t.to(device=ref.device, dtype=ref.dtype)
            out.append(arr)
        return _unflatten(like_state, out), step
