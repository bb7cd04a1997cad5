"""Quickstart on the PyTorch port: monitor a two-kernel streaming
pipeline online.

The paper's Figure 1 setup: kernel A -> queue -> kernel B.  We set B's
service rate ourselves, then watch the monitor recover it online without
being told.  The twin of ``examples/quickstart.py``: the pipeline's
fleet monitor runs its dispatches on the card (``--device cuda``, the
default; with no card it raises) or on the host (``--device cpu``).

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse
import time

from repro_torch.core.monitor import MonitorConfig
from repro_torch.streams import Pipeline, Stage

SET_RATE = 20_000  # items/s we secretly give kernel B
ITEMS = 60_000


def kernel_b(x):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.0 / SET_RATE:
        pass
    return x * 2


def run(items=ITEMS, *, device="cuda"):
    """Run A -> B over ``items`` items and return what the monitor saw:
    {"processed", "rates" (``Pipeline.rates()``), "estimate" (the A->B
    link's service rate), "dispatches"}."""
    pipe = Pipeline(
        [Stage("A", source=range(items)), Stage("B", fn=kernel_b)],
        capacity=64, base_period_s=2e-3,
        monitor_cfg=MonitorConfig(window=16, min_q_samples=16),
        device=device)
    out = pipe.run_collect(timeout_s=120)
    rates = pipe.rates()
    return {"processed": len(out), "rates": rates,
            "estimate": rates["A->B"]["service_rate"],
            "dispatches": pipe.fleet.dispatches}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    print(f"running pipeline; B's true (hidden) rate = {SET_RATE}/s ...")
    res = run(device=args.device)
    print(f"processed {res['processed']} items")
    for name, r in res["rates"].items():
        print(f"queue {name}:")
        print(f"  estimated service rate : {r['service_rate']:.0f}/s")
        print(f"  converged epochs       : {r['epochs']}")
        print(f"  blocking fraction      : {r['blocking_frac']:.2f}")
    est = res["estimate"]
    if est:
        print(f"\nmonitor error vs set rate: "
              f"{(est - SET_RATE) / SET_RATE:+.1%} "
              "(paper Fig 13: majority within 20%)")
    return res


if __name__ == "__main__":
    main()
