#!/usr/bin/env python3
"""Time the SSD backward kernel (and the SSD forward) of another checkout
and of this tree in turns, on one card, with each backward's device time
split by kernel.

    python3 scripts/ssd_bwd_turns.py [PARENT_DIR] [--seed 0]

PARENT_DIR holds another commit's tree (a ``git archive`` unpacked into
a gitignored directory will do).  Its
``src/repro_torch/kernels/ssd/kernel.py`` is loaded beside this tree's
and its sources are built; the rest of ``repro_torch`` is this tree's,
so the two wrappers must share its interfaces.  Without PARENT_DIR only
this tree is measured.  At the training path's chunk step
``chip_smoke.SSD_TRAIN_SHAPE`` (f32, Mamba-2's init, random cotangents
on y, state and decay) each backward is first held against
``ssd_chunk_bwd_ref`` (``chip_smoke.ssd_bwd_gate``, 1e-4 of each slice's
scale), then timed by CUDA events (10 calls after 2 warm ones) in the
order parent, this tree, this tree, parent, then profiled over 5 calls
(``chip_smoke.ssd_bwd_kernel_split``: device ms a call per kernel).  The
forward is timed the same way at the prefill's chunk step
``chip_smoke.SSD_SHAPE``.  Prints the card and one JSON line.
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
    ap.add_argument("parent", type=Path, nargs="?")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ssd_bwd_turns.py: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from repro_torch.kernels._build import ptxas_report
    from repro_torch.kernels.ssd import kernel as K
    from repro_torch.kernels.ssd import ref as R

    mods = {"this": K}
    if args.parent is not None:
        spec = importlib.util.spec_from_file_location(
            "parent_ssd_kernel",
            args.parent / "src/repro_torch/kernels/ssd/kernel.py")
        PK = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(PK)
        mods["parent"] = PK
    for mod in mods.values():
        mod.build()
        mod.build_bwd()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    g = torch.Generator(device=dev).manual_seed(args.seed)

    B, c, Q, H, P, N = shape = CS.SSD_TRAIN_SHAPE
    ins = CS._ssd_inputs(torch, rng, (B, c, Q), H, P, N, dev, init=True)
    cots = CS._ssd_cotangents(torch, g, shape, dev)
    want = R.ssd_chunk_bwd_ref(*ins, *cots)
    scale = R.ssd_dA_scale(*ins, *cots)
    gates = {side: CS.ssd_bwd_gate(torch, f"{side} ssd_chunk_bwd {shape}",
                                   mod.ssd_chunk_bwd(*ins, *cots), want,
                                   scale)[2]
             for side, mod in mods.items()}
    del want
    fB, fc, fQ, fH, fP, fN = CS.SSD_SHAPE
    fins = CS._ssd_inputs(torch, rng, (fB, fc, fQ), fH, fP, fN, dev,
                          init=True)
    order = (("parent", "this", "this", "parent") if "parent" in mods
             else ("this", "this"))
    bwd = {side: [] for side in mods}
    fwd = {side: [] for side in mods}
    for side in order:
        mod = mods[side]
        bwd[side].append(CS.event_ms(
            torch, lambda: mod.ssd_chunk_bwd(*ins, *cots), reps=10, warm=2))
    for side in order:
        mod = mods[side]
        fwd[side].append(CS.event_ms(
            torch, lambda: mod.ssd_chunk(*fins), reps=10, warm=2))
    split = {side: CS.ssd_bwd_kernel_split(
        torch, lambda: mod.ssd_chunk_bwd(*ins, *cots))
        for side, mod in mods.items()}
    bound_ms, bound_by, nbytes, flops = CS.ssd_bwd_bound(shape)
    out = {"shape": shape, "bwd_ms": bwd, "bwd_split_ms": split,
           "bwd_gate": gates,
           "bwd_tflops": {s: flops / (sum(t) / len(t)) / 1e9
                          for s, t in bwd.items()},
           "bound_ms": bound_ms, "bound_by": bound_by,
           "fwd_shape": CS.SSD_SHAPE, "fwd_ms": fwd}
    out["ptxas"] = {side: [
        {k: r[k] for k in ("kernel", "registers", "spill_stores",
                           "spill_loads")}
        for r in ptxas_report(
            Path(str(mod.build_bwd()) + ".log").read_text())]
        for side, mod in mods.items()}
    print(CS.card_line())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
