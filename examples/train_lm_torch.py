"""End-to-end driver on the PyTorch port: train a ~100M-param LM for a
few hundred steps with the monitor-instrumented data pipeline,
checkpoint/restart, and the service-rate-driven controllers.

The twin of ``examples/train_lm.py``: the model, its optimizer state
and the data pipeline's fleet monitor live on the card (``--device
cuda``, the default; with no card it raises) or on the host (``--device
cpu``); the random weights come from ``--seed``.  A second run with the
same ``--ckpt`` resumes at the last checkpoint's step.

  PYTHONPATH=src python examples/train_lm_torch.py --steps 200
"""

import argparse
import dataclasses
import os
import tempfile
import time

from repro_torch.configs.base import ArchConfig
from repro_torch.data import DataPipeline, SyntheticLMSource
from repro_torch.models import build_model
from repro_torch.train import OptConfig, TrainConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

# ~100M params: 12L x 512 x 8H, d_ff 2048, 32k vocab
LM_100M = ArchConfig(
    name="repro-lm-100m", family="dense", n_layers=12, d_model=512,
    n_heads=8, n_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32_000,
    rope_mode="rope", mlp_act="swiglu", norm="rmsnorm")
# the --small variant for quick runs: 4L/256d
SMALL = dict(n_layers=4, d_model=256, d_ff=1024, n_heads=4, n_kv_heads=2,
             vocab_size=4096)
CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


def config(small=False) -> ArchConfig:
    return dataclasses.replace(LM_100M, **SMALL) if small else LM_100M


def train(steps=200, batch=8, seq=256, ckpt=CKPT_DIR, small=False, *,
          device="cuda", seed=0, ckpt_every=100, log_every=10):
    """Build the model (restoring the latest checkpoint under ``ckpt``,
    if any), then ``Trainer.fit`` for ``steps`` more steps on
    ``DataPipeline(SyntheticLMSource)`` batches of ``batch`` x ``seq``.
    Returns {"cfg", "start" (the step resumed at, 0 for a fresh run),
    "history", "wall_s", "rates" (the data links' readout),
    "stragglers", "ckpt_steps"}; the pipeline is stopped."""
    cfg = config(small)
    model = build_model(cfg)
    print(f"arch {cfg.name}: {cfg.n_params() / 1e6:.0f}M params")

    trainer = Trainer(model, TrainerConfig(
        train=TrainConfig(opt=OptConfig(lr_peak=3e-4, warmup_steps=50,
                                        total_steps=steps),
                          remat_policy=None),
        ckpt_dir=ckpt, ckpt_every=ckpt_every, log_every=log_every),
        seed=seed, device=device)
    start = trainer.maybe_restore()
    if start:
        print(f"auto-resumed from checkpoint at step {start}")

    pipe = DataPipeline(SyntheticLMSource(cfg.vocab_size, doc_len=512),
                        seq_len=seq, batch_size=batch,
                        queue_capacity=8,
                        max_batches=steps + 8, device=device).start()
    try:
        t0 = time.time()
        hist = trainer.fit(iter(pipe), steps=steps)
        dt = time.time() - t0
    finally:
        pipe.stop()
    return {"cfg": cfg, "start": start, "history": hist, "wall_s": dt,
            "rates": pipe.rates(), "stragglers": trainer.ft.rates.stragglers(),
            "ckpt_steps": trainer.ckpt.steps()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=CKPT_DIR)
    ap.add_argument("--small", action="store_true",
                    help="4L/256d variant for quick runs")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    res = train(args.steps, args.batch, args.seq, args.ckpt, args.small,
                device=args.device, seed=args.seed)
    hist = res["history"]
    first, last = hist[0], hist[-1]
    print(f"\nsteps {first['step']}->{last['step']} in {res['wall_s']:.0f}s "
          f"({last['steps_per_s']:.2f} steps/s)")
    print(f"loss {first['loss']:.3f} -> {last['loss']:.3f}")
    print("data-pipeline service rates (monitor):")
    for name, r in res["rates"].items():
        print(f"  {name}: service={r['service_rate']:.1f}/s "
              f"arrivals={r['arrival_rate']:.1f}/s epochs={r['epochs']}")
    print("straggler check:", res["stragglers"] or "none")
    print(f"checkpoints: {res['ckpt_steps']} in {args.ckpt}")
    return res


if __name__ == "__main__":
    main()
