"""Serve a small model with batched requests through the PyTorch port's
monitored engine; the request queue's converged service rate drives the
analytic queue-capacity recommendation.

The twin of ``examples/serve_decode.py``: the model, its random weights
(from ``--seed``) and the lanes' fleet monitor live on the card
(``--device cuda``, the default; with no card it raises) or on the host
(``--device cpu``).

  PYTHONPATH=src python examples/serve_decode_torch.py --requests 24
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serve import Engine, Request, ServeConfig


def serve(arch="internlm2-1.8b", requests=24, *, device="cuda", seed=0,
          model=None, params=None):
    """``requests`` prompts of 8 tokens, 8 new tokens each, through
    ``Engine(batch_size=4, max_seq=64, queue_capacity=16)`` on
    ``arch``'s smoke config.  ``model`` and ``params`` default to
    ``build_model(cfg)`` and its random float32 weights from ``seed``.
    Returns {"reqs", "served", "tokens", "wall_s", "service_rate",
    "recommended", "stats"}; the engine is stopped."""
    cfg = get_smoke_config(arch)
    dev = resolve_device(device)
    if model is None:
        model = build_model(cfg)
    if params is None:
        params = model.init_params(
            torch.Generator(device=dev).manual_seed(seed), device=dev)
    eng = Engine(model, params,
                 ServeConfig(batch_size=4, max_seq=64, queue_capacity=16),
                 device=dev).start()
    try:
        rng = np.random.default_rng(seed)
        reqs = [Request(rid=i,
                        tokens=rng.integers(0, cfg.vocab_size, size=8),
                        max_new=8) for i in range(requests)]
        t0 = time.time()
        for r in reqs:
            eng.submit(r)
        for r in reqs:
            r.done.wait(timeout=300)
        dt = time.time() - t0
        return {"reqs": reqs,
                "served": sum(r.out is not None for r in reqs),
                "tokens": sum(len(r.out) for r in reqs
                              if r.out is not None),
                "wall_s": dt, "service_rate": eng.service_rate(),
                "recommended": eng.recommended_queue_capacity(),
                "stats": eng.stats()}
    finally:
        eng.stop()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    res = serve(args.arch, args.requests, device=args.device,
                seed=args.seed)
    reqs, dt, toks = res["reqs"], res["wall_s"], res["tokens"]
    print(f"served {res['served']}/{len(reqs)} requests, {toks} tokens "
          f"in {dt:.1f}s ({toks / dt:.1f} tok/s)")
    print(f"sample continuation for request 0: {reqs[0].out}")
    print(f"monitored queue service rate: {res['service_rate']:.2f} req/s")
    print(f"analytic queue-capacity recommendation: {res['recommended']}")
    return res


if __name__ == "__main__":
    main()
