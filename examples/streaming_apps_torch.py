"""The paper's two full applications (sections V-B/VI) on the PyTorch
port's streaming substrate: matrix multiply (Fig 16) and Rabin-Karp
search (Fig 17), with their queues monitored online -- every link rides
the one-dispatch-per-tick fleet monitor, and the control plane reads
(Q,) estimate arrays.

The twin of ``examples/streaming_apps.py``, with its own copies of
``benchmarks/apps.py``'s two applications.  The fleet monitor and the
control loop's decision run on the card (``--device cuda``, the
default; with no card it raises) or on the host (``--device cpu``); the
applications' kernels are the reference's numpy and byte code.

  PYTHONPATH=src python examples/streaming_apps_torch.py [--device cpu]
"""

import argparse
import time

import numpy as np

from repro_torch.core.monitor import MonitorConfig
from repro_torch.streams import Pipeline, Stage

MATMUL_N = 256
CORPUS_REPEATS = 200_000          # b"foobar" * 200_000: 1.2 MB
CHUNK_LEN = 4096


def fig16_matmul_app(n=MATMUL_N, *, device="cuda"):
    """Streaming dense matmul: reader -> n dot-product kernels -> reduce.
    The reduce kernel's queue is instrumented (as in the paper).
    Returns (rows, verdict, info); info holds ``A``, ``B``, ``acc``,
    ``ok`` (acc allclose to A @ B at atol 1e-3), ``rows_out``, the
    reduce link's ``reduce_rate`` and the fleet's ``dispatches``."""
    A = np.random.default_rng(0).normal(size=(n, n)).astype(np.float32)
    B = np.random.default_rng(1).normal(size=(n, n)).astype(np.float32)

    def rows():
        for i in range(n):
            yield (i, A[i])

    def dot(item):
        i, row = item
        return (i, row @ B)

    acc = np.zeros((n, n), np.float32)

    def reduce(item):
        i, r = item
        acc[i] = r
        return item

    pipe = Pipeline([Stage("read", source=rows()),
                     Stage("dot", fn=dot, replicas=4),
                     Stage("reduce", fn=reduce)],
                    capacity=32, base_period_s=2e-3,
                    monitor_cfg=MonitorConfig(window=16, min_q_samples=16),
                    device=device)
    t0 = time.perf_counter()
    out = pipe.run_collect(timeout_s=120)
    dt = time.perf_counter() - t0
    ok = np.allclose(acc, A @ B, atol=1e-3)
    rates = pipe.rates()
    reduce_rate = rates["dot->reduce"]["service_rate"]
    return ([f"fig16_matmul,{dt * 1e6:.0f},rows={len(out)}_correct={ok}"
             f"_reduce_rate={reduce_rate:.0f}/s"],
            f"matmul correct={ok}; instrumented reduce kernel rate "
            f"{reduce_rate:.0f} rows/s (paper Fig 16 instruments reduce)",
            {"A": A, "B": B, "acc": acc, "ok": bool(ok),
             "rows_out": len(out), "reduce_rate": reduce_rate,
             "wall_s": dt, "dispatches": pipe.fleet.dispatches})


def fig17_rabin_karp(repeats=CORPUS_REPEATS, chunk_len=CHUNK_LEN, *,
                     device="cuda"):
    """Rabin-Karp over a 'foobar' corpus; hash kernel's out-queue
    instrumented (paper: low-rho, hard-to-observe case).  Returns (rows,
    verdict, info); info holds ``matches``, ``expected`` (the corpus
    length over the pattern's), the verify link's ``verify_rate`` and
    ``blocking_frac`` and the fleet's ``dispatches``."""
    corpus = (b"foobar" * repeats)
    pattern = b"foobar"
    m = len(pattern)
    q = (1 << 31) - 1
    base = 256
    h_pat = 0
    for c in pattern:
        h_pat = (h_pat * base + c) % q

    def chunks():
        for off in range(0, len(corpus) - m + 1, chunk_len):
            yield (off, corpus[off:off + chunk_len + m - 1])

    def rolling_hash(item):
        off, text = item
        hits = []
        h = 0
        hi = pow(base, m - 1, q)
        for i, c in enumerate(text):
            h = (h * base + c) % q
            if i >= m - 1:
                if h == h_pat:
                    hits.append(off + i - m + 1)
                h = (h - text[i - m + 1] * hi) % q
        return (off, text, hits)

    def verify(item):
        off, text, hits = item
        real = [p for p in hits
                if corpus[p:p + m] == pattern]
        return real

    pipe = Pipeline([Stage("read", source=chunks()),
                     Stage("hash", fn=rolling_hash, replicas=4),
                     Stage("verify", fn=verify, replicas=2)],
                    capacity=32, base_period_s=2e-3,
                    monitor_cfg=MonitorConfig(window=16, min_q_samples=16),
                    device=device)
    t0 = time.perf_counter()
    out = pipe.run_collect(timeout_s=180)
    dt = time.perf_counter() - t0
    n_matches = sum(len(x) for x in out)
    expect = len(corpus) // m
    rates = pipe.rates()
    vq = rates["hash->verify"]
    return ([f"fig17_rabin_karp,{dt * 1e6:.0f},matches={n_matches}"
             f"_expected~{expect}_verify_rate={vq['service_rate']:.0f}"
             f"_blockfrac={vq['blocking_frac']:.2f}"],
            f"found {n_matches}/{expect} matches; verify-queue blocking "
            f"fraction {vq['blocking_frac']:.2f} (paper: low-rho queue is "
            "the hard case)",
            {"matches": n_matches, "expected": expect, "chunks": len(out),
             "verify_rate": vq["service_rate"],
             "blocking_frac": vq["blocking_frac"], "wall_s": dt,
             "dispatches": pipe.fleet.dispatches})


ALL = [fig16_matmul_app, fig17_rabin_karp]


def fleet_control_demo(items=30_000, *, device="cuda"):
    """A short pipeline showing the vectorized control-plane readouts:
    per-link gated rates, fused monitoring dispatch count, and the
    replica recommendation computed from the fleet arrays.  Returns
    {"items", "dispatches", "rates", "replicas"}."""
    pipe = Pipeline([Stage("src", source=range(items)),
                     Stage("square", fn=lambda x: x * x),
                     Stage("tag", fn=lambda x: (x, x % 7))],
                    capacity=64, base_period_s=1e-3,
                    monitor_cfg=MonitorConfig(window=16, min_q_samples=16),
                    device=device)
    pipe.fleet.warmup()      # the first dispatch's set-up off the run
    out = pipe.run_collect(timeout_s=120)
    print(f"== fleet_control_demo ({len(out)} items, "
          f"{pipe.fleet.dispatches} fused monitor dispatches)")
    rates = pipe.rates()
    for name, entry in rates.items():
        print(f"   {name}: mu={entry['service_rate']:.0f}/s "
              f"lam={entry['arrival_rate']:.0f}/s "
              f"epochs={entry['epochs']} "
              f"blocked={entry['blocking_frac']:.2f}")
    replicas = pipe.recommended_replicas()
    print("   recommended replicas:", replicas)
    return {"items": len(out), "out": out, "dispatches":
            pipe.fleet.dispatches, "rates": rates, "replicas": replicas}


def closed_loop_demo(items=12_000, *, device="cuda"):
    """Closed-loop elastic actuation: the same pipeline with
    ``control=True`` runs a ``repro_torch.control`` ControlLoop -- replica
    and buffer policies evaluated against the gated fleet estimates once
    per fused dispatch, actuated live through ``scale_stage`` /
    ``resize``, every decision audited in the ControlLog ring.  Returns
    {"items", "out", "live_replicas", "counts", "dispatches", "stats"}."""
    def slowish(x):
        # a deliberately heavy (I/O-shaped) stage: one replica caps the
        # pipeline at ~2500 items/s, so the loop should want replicas
        time.sleep(4e-4)
        return x + 1

    pipe = Pipeline([Stage("src", source=range(items)),
                     Stage("heavy", fn=slowish)],
                    capacity=64, base_period_s=1e-3, control=True,
                    monitor_cfg=MonitorConfig(window=16, min_q_samples=16),
                    device=device)
    pipe.fleet.warmup()      # set-up off the run so sampling starts
    pipe.control.warmup()    # with the first items
    out = pipe.run_collect(timeout_s=120)
    log = pipe.control.log
    live = pipe.live_replicas("heavy")
    print(f"== closed_loop_demo ({len(out)} items)")
    print(f"   live replicas of 'heavy': {live}"
          f"  (advisory: {pipe.recommended_replicas()})")
    print(f"   control decisions: {log.counts() or 'none fired'}")
    for rec in log.tail(4):
        print(f"   [{rec.tick}] {rec.policy}/{rec.action} q{rec.queue} "
              f"-> {rec.value} ({rec.outcome}; mu={rec.observed_mu:.0f}/s"
              f" lam={rec.observed_lam:.0f}/s)")
    return {"items": len(out), "out": out, "live_replicas": live,
            "counts": log.counts(), "dispatches": pipe.fleet.dispatches,
            "stats": pipe.stats()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    res = {}
    for fn in ALL:
        rows, verdict, res[fn.__name__] = fn(device=args.device)
        print(f"== {fn.__name__}")
        for r in rows:
            print("  ", r)
        print("  verdict:", verdict)
    res["fleet_control_demo"] = fleet_control_demo(device=args.device)
    res["closed_loop_demo"] = closed_loop_demo(device=args.device)
    return res


if __name__ == "__main__":
    main()
