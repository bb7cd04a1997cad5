#!/usr/bin/env python3
"""Time the fleet monitor's two CUDA kernels of another checkout and of
this tree in turns, on one card.

    python3 scripts/monitor_kernel_turns.py PARENT_DIR [--seed 0]

PARENT_DIR holds another commit's tree (a ``git archive`` unpacked into
a gitignored directory will do).  Its
``src/repro_torch/kernels/monitor/kernel.py`` is loaded beside this
tree's and both sources are built; the rest of ``repro_torch`` is this
tree's, so the two wrappers must share its interfaces.  Each kernel is
timed at its path's shape by the replay of a CUDA graph of many calls on
inputs that together exceed the L2 cache (``chip_smoke.graph_ms``), in
the order parent, this tree, this tree, parent, on the same inputs:
``batched_monitor`` at (2e5, 32) f32, and ``monitor_fleet`` in state
mode on one (2e5, 32) dispatch tile from a mid-stream state -- the
parent on the row-major tile, this tree on the time-major one, the
layouts each one's service passes.  Prints the card and one JSON line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("monitor_kernel_turns.py: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from repro_torch.core import monitor as M
    from repro_torch.kernels.monitor import kernel as K
    from repro_torch.kernels.monitor import ops as O

    spec = importlib.util.spec_from_file_location(
        "parent_monitor_kernel",
        args.parent / "src/repro_torch/kernels/monitor/kernel.py")
    PK = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(PK)
    PK.build()
    K.build()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)

    xs = [torch.as_tensor(rng.uniform(0, 500, (CS.WINDOW_Q, 32)).astype(
        np.float32), device=dev) for _ in range(6)]
    cfg = M.MonitorConfig()
    tc, blocked = CS.noisy_streams(rng, CS.N_STREAMS, 1024)
    seed_state, _ = M.run_monitor_fleet(
        cfg, torch.as_tensor(tc, device=dev),
        torch.as_tensor(blocked, device=dev), chunk_t=CS.CHUNK, mode="state",
        device=dev)
    tiles = [CS._staged_tile(torch, O, rng, CS.SVC_CHUNK, dev)
             for _ in range(2)]
    works = [CS.clone_state(seed_state) for _ in tiles]

    def batched(mod):
        return lambda: CS.graph_ms(
            torch, [lambda x=x: mod.batched_monitor(x) for x in xs], 48)

    def fleet(mod, layout):
        return lambda: CS.graph_ms(torch, [
            lambda w=w, t=t: mod.monitor_fleet(cfg, w, *t[layout], full=False)
            for w, t in zip(works, tiles)], 20)

    runs = {"batched_monitor": (batched(PK), batched(K)),
            "monitor_fleet": (fleet(PK, 1), fleet(K, 0))}
    out = {}
    for name, (parent, this) in runs.items():
        times = {"parent": [], "this": []}
        for side in ("parent", "this", "this", "parent"):
            times[side].append(parent() if side == "parent" else this())
        out[name] = times
    print(CS.card_line())
    print(json.dumps({"turns_ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
