#!/usr/bin/env python3
"""gemma2-2b's serving prefill and training step from two checkouts on
one card, in turns.

    python3 scripts/gemma2_turns.py PARENT_DIR
    python3 scripts/gemma2_turns.py --tree DIR     # one run, one JSON line

Each run is its own process on one checkout (PARENT_DIR holds another
commit's tree, e.g. a ``git archive`` unpacked into the gitignored
``build/``): it builds that tree's kernels, then runs its
``chip_smoke.phase_gemma2`` (the 2 x 8192 prefill, the kernel against
plain attention, the f32 gates at a 2-layer cut, 16 decode steps) and
its ``chip_smoke.phase_trainer`` on gemma2-2b in full (26 layers, 2 x 1
x 8192, remat "dots", AdamW, 8 steps; a profiled step splits the device
time by kernel), and prints one JSON line that names the card.  Without
``--tree`` the runs go parent, this tree, this tree, parent, each line
printed as it comes.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run_tree(tree: Path) -> int:
    sys.path[:0] = [str(tree), str(tree / "src")]
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("gemma2_turns.py: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from repro_torch import configs as C
    from repro_torch import data as D
    from repro_torch import models as MD
    from repro_torch.kernels.attention import kernel as AK
    from repro_torch.kernels.monitor import kernel as K
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.models import transformer as TF
    from repro_torch.train import step as TS

    if Path(CS.__file__).resolve().parent != tree:
        raise RuntimeError(f"chip_smoke from {CS.__file__}, not {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    builds = (K.build, AK.build, AK.build_bwd, SK.build, SK.build_bwd)
    with ThreadPoolExecutor(len(builds)) as pool:   # one nvcc each
        for done in [pool.submit(b) for b in builds]:
            done.result()
    t0 = time.perf_counter()
    _, gemma = CS.phase_gemma2(torch, AK, TF, C, MD,
                               np.random.default_rng(0), 0, dev)
    t1 = time.perf_counter()
    cfg = C.get_config(CS.GEMMA_ARCH)
    _, fit = CS.phase_trainer(torch, AK, K, C, MD, TS, D, dev, 0,
                              arch=CS.GEMMA_ARCH, micro=CS.GEMMA_TRAIN_MICRO,
                              rows=CS.GEMMA_TRAIN_ROWS, cfg=cfg,
                              seq=CS.GEMMA_TRAIN_SEQ)
    t2 = time.perf_counter()
    print(json.dumps({"tree": str(tree), "card": CS.card_line(),
                      "prefill_phase_s": t1 - t0, "fit_phase_s": t2 - t1,
                      "gemma2": gemma, "fit": fit}, default=str))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parent", type=Path, nargs="?")
    ap.add_argument("--tree", type=Path)
    args = ap.parse_args()
    if args.tree is not None:
        return run_tree(args.tree.resolve())
    if args.parent is None:
        ap.error("give PARENT_DIR, or --tree DIR")
    rc = 0
    for tree in (args.parent, ROOT, ROOT, args.parent):
        res = subprocess.run([sys.executable, __file__, "--tree",
                              str(tree.resolve())], capture_output=True,
                             text=True)
        print(res.stdout.strip().splitlines()[-1] if res.returncode == 0
              else json.dumps({"tree": str(tree), "rc": res.returncode,
                               "stderr": res.stderr[-2000:]}), flush=True)
        rc = rc or res.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
