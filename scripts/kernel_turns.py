#!/usr/bin/env python3
"""Time a hand-written kernel of another checkout and of this tree in
turns, on one card.

    python3 scripts/kernel_turns.py {flash_bwd,ssd_bwd,monitor} \\
        [PARENT_DIR] [--seed 0]

PARENT_DIR holds another commit's tree (a ``git archive`` unpacked into
a gitignored directory will do).  Its
``src/repro_torch/kernels/<package>/kernel.py`` is loaded beside this
tree's and its sources are built; the rest of ``repro_torch`` is this
tree's, so the two wrappers must share its interfaces.  Without
PARENT_DIR only this tree is measured.  Each side is first held against
the plain version, then every timing runs in the order parent, this
tree, this tree, parent on the same inputs.  Prints the card and one
JSON line.

* ``flash_bwd`` (package ``attention``): the bf16 flash-attention
  backward at the training path's shape ``chip_smoke.BWD_SHAPE`` (causal,
  no softcap, no window: the internlm2 training path), held against
  ``attention_bwd_ref`` under one forward (rel L2 1e-2 per output), timed
  by CUDA events (20 calls after 2 warm ones), then profiled over 5 calls
  (``chip_smoke.bwd_kernel_split``: device ms a call per kernel).
* ``ssd_bwd`` (package ``ssd``): the SSD backward at the training path's
  chunk step ``chip_smoke.SSD_TRAIN_SHAPE`` (f32, Mamba-2's init, random
  cotangents on y, state and decay), held against ``ssd_chunk_bwd_ref``
  (``chip_smoke.ssd_bwd_gate``, 1e-4 of each slice's scale), timed by
  CUDA events (10 calls after 2 warm ones), then profiled
  (``chip_smoke.ssd_bwd_kernel_split``); the forward is timed the same
  way at the prefill's chunk step ``chip_smoke.SSD_SHAPE``.
* ``monitor`` (package ``monitor``): the fleet monitor's two kernels,
  each timed at its path's shape by the replay of a CUDA graph of many
  calls on inputs that together exceed the L2 cache
  (``chip_smoke.graph_ms``): ``batched_monitor`` at (2e5, 32) f32, and
  ``monitor_fleet`` in state mode on one (2e5, 32) time-major dispatch
  tile from a mid-stream state.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def _ptxas(mods, keep=lambda name: True):
    """Registers and spills of each side's backward kernels."""
    from repro_torch.kernels._build import ptxas_report
    return {side: [
        {k: r[k] for k in ("kernel", "registers", "spill_stores",
                           "spill_loads")}
        for r in ptxas_report(
            Path(str(mod.build_bwd()) + ".log").read_text())
        if keep(r["kernel"])]
        for side, mod in mods.items()}


def flash_bwd(torch, CS, mods, rng, seed, dev):
    from repro_torch.kernels.attention import ref as AR
    B, S, H, K, hd = shape = CS.BWD_SHAPE
    q, k, v = CS._qkv(torch, rng, shape, torch.bfloat16, dev)
    do = torch.as_tensor(rng.standard_normal((B, S, H, hd)).astype(
        np.float32), device=dev)
    with torch.no_grad():
        o, lse = mods["this"].flash_attention(q, k, v, return_lse=True)
        want = AR.attention_bwd_ref(q, k, v, o, do)
        gates = {}
        for side, mod in mods.items():
            got = mod.flash_attention_bwd(q, k, v, o, do, lse)
            rels = [CS._rel_l2(g, w) for g, w in zip(got, want)]
            CS.check(max(rels) <= 1e-2, f"{side} flash_attention_bwd "
                     f"{shape}: rel L2 {rels} over 1e-2")
            gates[side] = rels
        del want, got
    torch.cuda.empty_cache()

    def run(mod):
        return lambda: mod.flash_attention_bwd(q, k, v, o, do, lse)
    bound_ms, bound_by, _, flops = CS.flash_bwd_bound(shape)
    out = {"shape": shape, "gate_rel_l2": gates,
           "split_ms": {side: CS.bwd_kernel_split(torch, run(mod))
                        for side, mod in mods.items()},
           "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
           "ptxas": _ptxas(mods, lambda n: "wgmma" in n or "prep" in n)}
    timers = {"flash_attention_bwd":
              lambda mod: CS.event_ms(torch, run(mod), reps=20)}
    return out, timers


def ssd_bwd(torch, CS, mods, rng, seed, dev):
    from repro_torch.kernels.ssd import ref as R
    g = torch.Generator(device=dev).manual_seed(seed)
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
    bound_ms, bound_by, _, flops = CS.ssd_bwd_bound(shape)
    out = {"shape": shape, "gate": gates,
           "split_ms": {side: CS.ssd_bwd_kernel_split(
               torch, lambda mod=mod: mod.ssd_chunk_bwd(*ins, *cots))
               for side, mod in mods.items()},
           "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
           "fwd_shape": CS.SSD_SHAPE, "ptxas": _ptxas(mods)}
    timers = {
        "ssd_chunk_bwd": lambda mod: CS.event_ms(
            torch, lambda: mod.ssd_chunk_bwd(*ins, *cots), reps=10, warm=2),
        "ssd_chunk": lambda mod: CS.event_ms(
            torch, lambda: mod.ssd_chunk(*fins), reps=10, warm=2)}
    return out, timers


def monitor(torch, CS, mods, rng, seed, dev):
    from repro_torch.core import monitor as M
    from repro_torch.kernels.monitor import ops as O
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
    timers = {
        "batched_monitor": lambda mod: CS.graph_ms(
            torch, [lambda x=x: mod.batched_monitor(x) for x in xs], 48),
        "monitor_fleet": lambda mod: CS.graph_ms(torch, [
            lambda w=w, t=t: mod.monitor_fleet(cfg, w, *t[0], full=False)
            for w, t in zip(works, tiles)], 20)}
    return {}, timers


CASES = {"flash_bwd": ("attention", flash_bwd), "ssd_bwd": ("ssd", ssd_bwd),
         "monitor": ("monitor", monitor)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("kernel", choices=sorted(CASES))
    ap.add_argument("parent", type=Path, nargs="?")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_turns.py: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS

    package, case = CASES[args.kernel]
    mods = {"this": importlib.import_module(
        f"repro_torch.kernels.{package}.kernel")}
    if args.parent is not None:
        spec = importlib.util.spec_from_file_location(
            f"parent_{package}_kernel",
            args.parent / f"src/repro_torch/kernels/{package}/kernel.py")
        mods["parent"] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods["parent"])
    for mod in mods.values():
        mod.build()
        if hasattr(mod, "build_bwd"):
            mod.build_bwd()
    dev = torch.device("cuda", 0)
    out, timers = case(torch, CS, mods, np.random.default_rng(args.seed),
                       args.seed, dev)
    order = (("parent", "this", "this", "parent") if "parent" in mods
             else ("this", "this"))
    turns = {name: {side: [] for side in mods} for name in timers}
    for name, timer in timers.items():
        for side in order:
            turns[name][side].append(timer(mods[side]))
    out["turns_ms"] = turns
    first = turns[next(iter(timers))]
    if "flops" in out:
        out["tflops"] = {s: out["flops"] / (sum(t) / len(t)) / 1e9
                         for s, t in first.items()}
    if "parent" in mods:
        out["this_over_parent"] = {
            name: sum(t["this"]) / sum(t["parent"])
            for name, t in turns.items()}
    print(CS.card_line())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
