#!/usr/bin/env python3
"""Measure what the chaos pipeline's replica cap and the supervisor's
rate leg do to its availability on one card, and time
``HostMonitor.update`` on this host.

    python3 scripts/chaos_replica_cap.py [--caps 64 16] [--repeats 3]
        [--stub-rate-leg-caps 64] [--seed 0]
    python3 scripts/chaos_replica_cap.py --host-monitor-only --src DIR

The chaos pipeline is ``chip_smoke.chaos_runs`` (a paced source, a
1.5 ms stage of 2 replicas under closed-loop control on the card, three
seeded kills and a monitor-thread death, a ``ReplicaSupervisor``), run
``--repeats`` times at each replica cap in ``--caps``, and at each cap
in ``--stub-rate-leg-caps`` once more per repeat with the supervisor's
per-replica Algorithm-1 rate leg (``HostRateTracker.record_steps``)
replaced by a no-op.  ``HostMonitor.update`` is timed on a seeded
Poisson stream on the host clock; ``--src`` points at another tree's
``src`` (a ``git archive`` unpacked into a gitignored directory) to time
its ``HostMonitor`` instead (only that, with ``--host-monitor-only``).
Prints the card and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def host_monitor_us(monitor_mod, n: int = 20_000, reps: int = 3) -> float:
    """Median µs an ``update`` over ``n`` Poisson samples, ``reps`` runs."""
    xs = np.random.default_rng(0).poisson(10, n).astype(float).tolist()
    times = []
    for _ in range(reps):
        hm = monitor_mod.HostMonitor(
            monitor_mod.MonitorConfig(window=16, min_q_samples=16),
            period_s=0.01)
        t0 = time.perf_counter()
        for x in xs:
            hm.update(x, False)
        times.append((time.perf_counter() - t0) / n * 1e6)
    return float(np.median(times))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--caps", type=int, nargs="*", default=[64, 16])
    ap.add_argument("--stub-rate-leg-caps", type=int, nargs="*",
                    default=[64])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--host-monitor-only", action="store_true")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(args.src.resolve())]
    from repro_torch.core import monitor as M
    out = {"src": str(args.src),
           "host_monitor_update_us": host_monitor_us(M)}
    if args.host_monitor_only:
        print(json.dumps(out))
        return 0

    import torch
    if not torch.cuda.is_available():
        print("chaos_replica_cap.py: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from repro_torch import control as CT
    from repro_torch import ft as FT
    from repro_torch import streams as S
    from repro_torch.ft import failures as FF
    from repro_torch.kernels.monitor import kernel as K
    print(CS.card_line(), flush=True)
    K.build()
    dev = torch.device("cuda", 0)
    real = FF.HostRateTracker.record_steps
    runs = []
    plan = [(cap, False) for cap in args.caps] + [
        (cap, True) for cap in args.stub_rate_leg_caps]
    for _ in range(args.repeats):
        for cap, stub in plan:
            FF.HostRateTracker.record_steps = (
                (lambda self, *a, **kw: None) if stub else real)
            try:
                r = CS.chaos_runs(torch, K, CT, S, M, FT, dev, args.seed,
                                  max_replicas=cap)
            finally:
                FF.HostRateTracker.record_steps = real
            row = {"cap": cap, "rate_leg": not stub,
                   **{k: r[k] for k in ("availability", "recovery",
                                        "t_base", "t_chaos", "peak",
                                        "respawns", "unhandled")}}
            print(json.dumps(row), flush=True)
            runs.append(row)
    out["runs"] = runs
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
