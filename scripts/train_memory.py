#!/usr/bin/env python3
"""Peak device memory of two train steps at depth cuts of one model, on
one card: what sizes a ``Trainer.fit`` phase of ``chip_smoke.py``.

    python3 scripts/train_memory.py [--arch gemma2-2b] [--seq 8192]
        [--micro 2] [--rows 1] LAYERS [LAYERS ...]

For each layer count, the model at its published widths cut to that
depth gets a ``Trainer`` (float32 master weights, AdamW, the default
remat "dots", ``--micro`` microbatches of ``--rows`` rows) and two train
steps on one random batch of ``--seq`` tokens; it prints the memory held
before, after the trainer's init and at the peak
(``torch.cuda.max_memory_allocated``), each step's ms and loss, or the
out-of-memory error.  A cut that runs out of memory is dropped before
the next one is built.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def one_cut(torch, cfg, layers, batch, micro, dev):
    """(peak GB, GB after init, [(step ms, loss)]) of two steps at
    ``layers`` layers, or the out-of-memory message in place of the
    steps."""
    from repro_torch import models as MD
    from repro_torch.train import OptConfig, TrainConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    c = dataclasses.replace(cfg, n_layers=layers)
    tcfg = TrainerConfig(train=TrainConfig(
        opt=OptConfig(lr_peak=1e-3, lr_min=1e-4, warmup_steps=2,
                      total_steps=100), microbatches=micro), log_every=2)
    steps, init = [], None
    try:
        trainer = Trainer(MD.build_model(c, torch.bfloat16), tcfg, seed=0,
                          device=dev)
        init = torch.cuda.max_memory_allocated() / 1e9
        for _ in range(2):
            t = time.perf_counter()
            trainer.state, m = trainer.step_fn(trainer.state, batch)
            torch.cuda.synchronize()
            steps.append(((time.perf_counter() - t) * 1e3,
                          float(m["loss"])))
    except torch.OutOfMemoryError as e:
        steps = str(e).split(". ")[0]
    return torch.cuda.max_memory_allocated() / 1e9, init, steps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("layers", type=int, nargs="+")
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--seq", type=int, default=8192)
    ap.add_argument("--micro", type=int, default=2)
    ap.add_argument("--rows", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("train_memory.py: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from repro_torch import configs as C
    from repro_torch.kernels.attention import kernel as AK
    from repro_torch.kernels.ssd import kernel as SK
    for build in (AK.build, AK.build_bwd, SK.build, SK.build_bwd):
        build()
    dev = torch.device("cuda", 0)
    cfg = C.get_config(args.arch)
    rng = np.random.default_rng(args.seed)
    toks = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (args.micro * args.rows, args.seq + 1)),
        device=dev)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    print(CS.card_line())
    for layers in args.layers:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 1e9
        peak, init, steps = one_cut(torch, cfg, layers, batch, args.micro,
                                    dev)
        print(f"{args.arch} at {layers} layers, {args.micro} x {args.rows} "
              f"x {args.seq}: held before {held:.2f} GB, after init "
              + (f"{init:.2f}" if init is not None else "not reached")
              + f" GB, peak {peak:.2f} GB; "
              + (", ".join(f"step {ms:.0f} ms loss {loss:.4f}"
                           for ms, loss in steps)
                 if isinstance(steps, list) else steps), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
