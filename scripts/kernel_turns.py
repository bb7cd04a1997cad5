#!/usr/bin/env python3
"""Time a hand-written kernel of another checkout and of this tree in
turns, on one card.

    python3 scripts/kernel_turns.py CASE [CASE ...] [PARENT_DIR] \\
        [--variant NAME ...] [--seed 0]

CASE is one of ``flash_bwd``, ``flash_fwd``, ``ssd_bwd``, ``monitor``;
several run in one call, on one build of each side.  PARENT_DIR holds
another commit's tree (a ``git archive`` unpacked into a gitignored
directory will do).  Its ``src/repro_torch/kernels/<package>/kernel.py``
is loaded beside this tree's and its sources are built; the rest of
``repro_torch`` is this tree's, so the two wrappers must share its
interfaces.  ``--variant`` adds a side built from a copy of this tree's
package sources with one change (``VARIANTS``: ``tanhf``, the softcap's
tanh as CUDA's accurate tanhf in the bf16 forward and backward;
``exp2f``, the forward's softmax exponentials as exp2f at every head
dim).  Without PARENT_DIR or a variant only this tree is measured.
Each side is first held against the plain version, then every timing
runs in the order of the other sides, this tree, this tree, the other
sides reversed (parent, this, this, parent) on the same inputs.  Prints
the card and one JSON line: each case's output under its name, the
turns, TFLOP/s where the case counts its operations, and this tree's
time over each other side's.

* ``flash_bwd`` (package ``attention``): the bf16 flash-attention
  backward at the training path's shape ``chip_smoke.BWD_SHAPE`` (causal,
  no softcap, no window: the internlm2 training path; and with grok-1's
  softcap 30, q x 4, which runs the split geometry) and at gemma2's
  training row ``chip_smoke.GEMMA_BWD_SHAPE`` (hd 256, causal, softcap
  50, q x 8 so that the cap bends the scores), windowed
  (``chip_smoke.GEMMA_WINDOW``) and global; each held against
  ``attention_bwd_ref`` under one forward (rel L2 1e-2 per output),
  timed by CUDA events (20 calls after 2 warm ones at hd 128, 10 at hd
  256), then profiled over 5 calls (``chip_smoke.bwd_kernel_split``:
  device ms a call per kernel); ptxas's registers and spills of each
  side's tensor-core and prep kernels.
* ``flash_fwd`` (package ``attention``): the bf16 forward at gemma2's
  prefill ``chip_smoke.GEMMA_FLASH_SHAPE`` (hd 256, causal, softcap 50,
  q x 8), windowed and global, held against ``attention_ref`` (1e-3
  abs + rel, the card's gate) and timed by CUDA events (20 calls);
  ptxas's registers and spills of each side's tensor-core kernels.
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
import re
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def _ptxas(mods, keep=lambda name: True, build="build_bwd"):
    """Registers and spills of each side's kernels in the library that
    ``build`` (``build_bwd`` or ``build``) makes."""
    from repro_torch.kernels._build import ptxas_report
    return {side: [
        {k: r[k] for k in ("kernel", "registers", "spill_stores",
                           "spill_loads")}
        for r in ptxas_report(
            Path(str(getattr(mod, build)()) + ".log").read_text())
        if keep(r["kernel"])]
        for side, mod in mods.items()}


def _gemma_cases(CS):
    """gemma2's hd 256 calls: (name, arguments), windowed and global."""
    cap = dict(causal=True, softcap=50.0)
    return (("hd256 window", dict(cap, window=CS.GEMMA_WINDOW)),
            ("hd256", cap))


def flash_bwd(torch, CS, mods, rng, seed, dev):
    from repro_torch.kernels.attention import ref as AR
    rows = [("hd128", CS.BWD_SHAPE, {}, 1.0, 20),
            ("hd128 softcap", CS.BWD_SHAPE,
             dict(causal=True, softcap=30.0), 4.0, 20)] + [
        (name, CS.GEMMA_BWD_SHAPE, kw, 8.0, 10)
        for name, kw in _gemma_cases(CS)]
    out = {"shape": {}, "gate_rel_l2": {}, "split_ms": {}, "bound_ms": {},
           "bound_by": {}, "flops": {}}
    timers = {}
    for name, shape, kw, qmul, reps in rows:
        B, S, H, K, hd = shape
        q, k, v = CS._qkv(torch, rng, shape, torch.bfloat16, dev, qmul=qmul)
        do = torch.as_tensor(rng.standard_normal((B, S, H, hd)).astype(
            np.float32), device=dev)
        with torch.no_grad():
            o, lse = mods["this"].flash_attention(q, k, v, return_lse=True,
                                                  **kw)
            want = AR.attention_bwd_ref(q, k, v, o, do, **kw)
            gates = {}
            for side, mod in mods.items():
                got = mod.flash_attention_bwd(q, k, v, o, do, lse, **kw)
                rels = [CS._rel_l2(g, w) for g, w in zip(got, want)]
                CS.check(max(rels) <= 1e-2, f"{side} flash_attention_bwd "
                         f"{name} {shape} {kw}: rel L2 {rels} over 1e-2")
                gates[side] = rels
            del want, got
        torch.cuda.empty_cache()

        def run(mod, a=(q, k, v, o, do, lse), kw=kw):
            return lambda: mod.flash_attention_bwd(*a, **kw)
        key = f"flash_attention_bwd {name}"
        out["shape"][key] = shape
        out["gate_rel_l2"][key] = gates
        out["split_ms"][key] = {side: CS.bwd_kernel_split(torch, run(mod))
                                for side, mod in mods.items()}
        (out["bound_ms"][key], out["bound_by"][key], _,
         out["flops"][key]) = CS.flash_bwd_bound(shape,
                                                 window=kw.get("window", 0))
        timers[key] = (lambda mod, run=run, reps=reps:
                       CS.event_ms(torch, run(mod), reps=reps))
    out["ptxas_bwd"] = _ptxas(mods, lambda n: "wgmma" in n or "prep" in n)
    return out, timers


def flash_fwd(torch, CS, mods, rng, seed, dev):
    from repro_torch.kernels.attention import ref as AR
    shape = CS.GEMMA_FLASH_SHAPE
    g = torch.Generator(device=dev).manual_seed(seed + 30)
    q, k, v = CS._qkv_on_card(torch, g, shape, torch.bfloat16, dev, 8.0)
    out = {"shape": {}, "gate_max_abs_err": {}, "bound_ms": {},
           "bound_by": {}, "flops": {}}
    timers = {}
    for name, kw in _gemma_cases(CS):
        key = f"flash_attention {name}"
        with torch.no_grad():
            want = AR.attention_ref(q, k, v, **kw)
            errs = {}
            for side, mod in mods.items():
                got = mod.flash_attention(q, k, v, **kw)
                d = (got - want).abs()
                CS.check(bool(torch.isfinite(got).all()
                              and (d <= 1e-3 + 1e-3 * want.abs()).all()),
                         f"{side} flash_attention {name} {shape} {kw}: max "
                         f"abs err {float(d.max())} over 1e-3")
                errs[side] = float(d.max())
            del want, got, d
        torch.cuda.empty_cache()
        out["shape"][key] = shape
        out["gate_max_abs_err"][key] = errs
        (out["bound_ms"][key], out["bound_by"][key], _,
         out["flops"][key]) = CS.flash_bound(shape,
                                             window=kw.get("window", 0))
        timers[key] = (lambda mod, kw=kw: CS.event_ms(
            torch, lambda: mod.flash_attention(q, k, v, **kw), reps=20))
    out["ptxas_fwd"] = _ptxas(mods, lambda n: "wgmma" in n, build="build")
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
           "bound_ms": bound_ms, "bound_by": bound_by,
           "flops": {"ssd_chunk_bwd": flops},
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


CASES = {"flash_bwd": ("attention", flash_bwd),
         "flash_fwd": ("attention", flash_fwd), "ssd_bwd": ("ssd", ssd_bwd),
         "monitor": ("monitor", monitor)}

# name -> (package, csrc file, pattern, replacement): one change to a
# copy of this tree's sources, which must match exactly once
VARIANTS = {
    "tanhf": ("attention", "hopper.cuh",
              r"(float softcap_tanh\(float x\) \{\n).*?(\n\})",
              r"\1  return tanhf(x);\2"),
    "exp2f": ("attention", "attention.cu",
              r"(softmax_exp2\(float x\) \{\n\s*if constexpr \()HDP > 128",
              r"\1false"),
}


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _variant(name: str):
    """This tree's package copied under ``build/kernel_turns/<name>/``
    with the variant's change, its kernel module loaded."""
    package, file, pattern, repl = VARIANTS[name]
    dst = ROOT / "build/kernel_turns" / name / package
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "src/repro_torch/kernels" / package, dst,
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = dst / "csrc" / file
    text, n = re.subn(pattern, repl, path.read_text(), flags=re.S)
    if n != 1:
        raise SystemExit(f"kernel_turns.py: variant {name}: {n} matches "
                         f"in {file}")
    path.write_text(text)
    return _load(f"{name}_{package}_kernel", dst / "kernel.py")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("args", nargs="+", metavar="CASE",
                    help="cases, then an optional PARENT_DIR")
    ap.add_argument("--variant", action="append", default=[],
                    choices=sorted(VARIANTS))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    cases, parent = args.args, None
    if cases[-1] not in CASES:
        *cases, parent = cases
        parent = Path(parent)
    bad = [c for c in cases if c not in CASES] + [
        v for v in args.variant
        if VARIANTS[v][0] not in {CASES[c][0] for c in cases}]
    if not cases or bad:
        ap.error(f"cases are {sorted(CASES)}, at most one PARENT_DIR last, "
                 f"and each variant's package among the cases': {bad}")
    import torch
    if not torch.cuda.is_available():
        print("kernel_turns.py: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS

    mods = {}   # package -> side -> kernel module
    for package in dict.fromkeys(CASES[c][0] for c in cases):
        side = mods[package] = {}
        if parent is not None:
            side["parent"] = _load(
                f"parent_{package}_kernel",
                parent / f"src/repro_torch/kernels/{package}/kernel.py")
        for v in args.variant:
            if VARIANTS[v][0] == package:
                side[v] = _variant(v)
        side["this"] = importlib.import_module(
            f"repro_torch.kernels.{package}.kernel")
    builds = [getattr(mod, name) for side in mods.values()
              for mod in side.values()
              for name in ("build", "build_bwd") if hasattr(mod, name)]
    with ThreadPoolExecutor(len(builds)) as pool:   # one nvcc each
        for done in [pool.submit(fn) for fn in builds]:
            done.result()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    out, turns, tflops = {}, {}, {}
    for name in cases:
        package, case = CASES[name]
        sides = mods[package]
        out[name], timers = case(torch, CS, sides, rng, args.seed, dev)
        others = [s for s in sides if s != "this"]
        order = others + ["this", "this"] + others[::-1]
        flops = out[name].pop("flops", {})
        for key, timer in timers.items():
            turns[key] = {side: [] for side in sides}
            for side in order:
                turns[key][side].append(timer(sides[side]))
            if key in flops:
                tflops[key] = {s: flops[key] / (sum(t) / len(t)) / 1e9
                               for s, t in turns[key].items()}
    result = {"cases": out, "turns_ms": turns, "tflops": tflops,
              "this_over": {key: {s: sum(t["this"]) / sum(ts)
                                  for s, ts in t.items() if s != "this"}
                            for key, t in turns.items()}}
    print(CS.card_line())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
