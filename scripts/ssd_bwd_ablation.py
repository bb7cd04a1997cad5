#!/usr/bin/env python3
"""Where the SSD backward's main kernel spends its time: this tree's
``ssd_bwd.cu`` built again with one part of ``ssd_bwd_main`` switched
off at a time, each timed on one card.

    python3 scripts/ssd_bwd_ablation.py

Each variant is a copy of ``src/repro_torch/kernels/ssd/csrc/ssd_bwd.cu``
(with ``tf32.cuh``) under ``build/ssd_bwd_ablation/``, compiled with
``-DABLATE=<bits>``; the copy has a guard inserted at each part, so a
variant computes wrong gradients and is only timed:

    1   the U = B_j.dstate^T product      4   the dM = dy_i.x_j^T product
    8   the dx_j += M^T.dy_i product      16  the stores of G o dt_j
    32  every cp.async copy (the steps read stale shared memory)
    64  the pair steps' elementwise epilogue (G, M, G o CB, the exps, the
        stores of G o dt_j; M^T is then dM^T)
    128 the in-order sum of acum (acum is then dt A)

Variant 0 is the kernel as it is, held against ``ssd_chunk_bwd_ref``
first.  All are built in parallel, then each is timed at
``chip_smoke.SSD_TRAIN_SHAPE`` (f32, Mamba-2's init) by CUDA events (two
runs of 10 calls) and profiled (``chip_smoke.ssd_bwd_kernel_split``).  A
variant's saving against variant 0 bounds what its part costs.  Prints
one JSON line per variant and the card.
"""

from __future__ import annotations

import json
import re
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
CSRC = ROOT / "src/repro_torch/kernels/ssd/csrc"
OUT = ROOT / "build/ssd_bwd_ablation"
VARIANTS = (0, 1, 4, 8, 16, 32, 64, 128, 1 | 4 | 8)

# (text in ssd_bwd.cu, the same text guarded by an ABLATE bit)
GUARDS = (
    ("      if (pw) {\n        // A (j, k = n)",
     "      if (pw && !(ABLATE & 1)) {\n        // A (j, k = n)"),
    ("      if (!(diag && wc > wr)) {",
     "      if (!(diag && wc > wr) && !(ABLATE & 4)) {"),
    ("      if (pw) {\n        // A (j, k = i)",
     "      if (pw && !(ABLATE & 8)) {\n        // A (j, k = i)"),
    ("            __stcg(reinterpret_cast<float2*>(dcb",
     "            if (!(ABLATE & 16)) __stcg(reinterpret_cast<float2*>(dcb"),
    ("  auto issue = [&](int s) {\n    float* b = stg",
     "  auto issue = [&](int s) {\n    if (ABLATE & 32) {\n      cp_commit();"
     "\n      return;\n    }\n    float* b = stg"),
    ("      float csum[4][2] = {}, rsum[2][2] = {};\n",
     "      float csum[4][2] = {}, rsum[2][2] = {};\n"
     "      if (!(ABLATE & 64)) {\n"),
    ("      // the column sums over the warp's rows",
     "      }\n      // the column sums over the warp's rows"),
    ("  if (tid < ng) {\n    float* a = acum",
     "  if (tid < ng && !(ABLATE & 128)) {\n    float* a = acum"),
)


def variant_source() -> Path:
    """The guarded copy of ssd_bwd.cu (and its header) under OUT."""
    text = (CSRC / "ssd_bwd.cu").read_text()
    for old, new in GUARDS:
        if text.count(old) != 1:
            raise SystemExit(f"ssd_bwd_ablation.py: ssd_bwd.cu no longer "
                             f"holds {old.strip()!r} once")
        text = text.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    for header in CSRC.glob("*.cuh"):
        shutil.copy(header, OUT / header.name)
    src = OUT / "ssd_bwd.cu"
    src.write_text("#ifndef ABLATE\n#define ABLATE 0\n#endif\n" + text)
    return src


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ssd_bwd_ablation.py: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from repro_torch.kernels._build import NvccLibrary, ptxas_report
    from repro_torch.kernels.ssd import kernel as K
    from repro_torch.kernels.ssd import ref as R

    src = variant_source()
    libs = {v: NvccLibrary(src, K.NVCC_FLAGS + (f"-DABLATE={v}",),
                           K._bind_bwd) for v in VARIANTS}
    with ThreadPoolExecutor(len(libs)) as ex:
        list(ex.map(lambda lib: lib.build(), libs.values()))
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    g = torch.Generator(device=dev).manual_seed(0)
    B, c, Q, H, P, N = shape = CS.SSD_TRAIN_SHAPE
    ins = CS._ssd_inputs(torch, rng, (B, c, Q), H, P, N, dev, init=True)
    cots = CS._ssd_cotangents(torch, g, shape, dev)
    own = K._LIBRARY_BWD
    try:
        for v, lib in libs.items():
            K._LIBRARY_BWD = lib
            call = lambda: K.ssd_chunk_bwd(*ins, *cots)  # noqa: E731
            if v == 0:
                CS.ssd_bwd_gate(torch, "ablation 0", call(),
                                R.ssd_chunk_bwd_ref(*ins, *cots),
                                R.ssd_dA_scale(*ins, *cots))
            ms = [CS.event_ms(torch, call, reps=10) for _ in range(2)]
            rep = ptxas_report(Path(str(lib.build()) + ".log").read_text())
            regs = {}
            for r in rep:
                m = re.search(r"(ssd_bwd_[a-z]+)(?:ILi(\d+)E)?E", r["kernel"])
                regs[f"{m.group(1)}<{m.group(2)}>" if m.group(2)
                     else m.group(1)] = [r["registers"], r["spill_stores"]]
            print(json.dumps({"ablate": v, "ms": ms,
                              "split_ms": CS.ssd_bwd_kernel_split(torch, call),
                              "registers_spills": regs}), flush=True)
    finally:
        K._LIBRARY_BWD = own
    print(CS.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
