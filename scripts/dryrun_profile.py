#!/usr/bin/env python3
"""Where one dry-run cell's trace time goes, on the CPU.

    PYTHONPATH=src python3 scripts/dryrun_profile.py --arch mamba2-2.7b \\
        --shape train_4k --mesh multi [--layers 2] [--seconds 300] \\
        [--src OTHER_TREE/src]

Runs ``launch.dryrun.lower_cell`` for one cell (its config cut to
``--layers`` layers, groups of the hybrid, when given) while a thread
samples the main thread's stack every ``--every`` seconds, and prints
the wall time and the share of samples inside each of:

* DTensor's sharding propagation on a cache miss
  (``propagate_op_sharding_non_cached``), and within it the
  redistribute costs of the candidate strategies
  (``generate_redistribute_costs``) and the redistribute planner's
  graph search (``generate_graph_based_transform_infos``);
* ``distribute_tensor`` (the dry run's ``_place`` of the inputs);
* the port's two dispatch modes (``roofline/counters.py``'s
  ``CollectiveCounter`` and ``MemoryTracker``), the samples whose
  innermost frame of the port is one of them;

then the hits and misses of DTensor's propagation cache and of the
redistribute planner's cache (``_gen_transform_infos``: each miss one
plan), and the port's frames that hold the most samples.  ``--seconds``
stops the cell there (a SIGALRM raises out of the trace) and reports
the time so far.  ``--src`` profiles another checkout's package (a
parent commit unpacked with ``git archive``).
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import signal
import sys
import threading
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# label -> (file suffix, function name); a sample counts under a label
# when its stack holds that function
SPLIT = {
    "sharding propagation, cache misses": (
        "_sharding_prop.py", "propagate_op_sharding_non_cached"),
    "  redistribute costs of the candidates": (
        "_ops/utils.py", "generate_redistribute_costs"),
    "  redistribute planner, graph search": (
        "_redistribute.py", "generate_graph_based_transform_infos"),
    "distribute_tensor (_place)": ("tensor/_api.py", "distribute_tensor"),
}
MODES = ("CollectiveCounter", "MemoryTracker")


class _Stop(BaseException):
    pass


def cut_config(get_config, layers: int):
    """``get_config`` with every config cut to ``layers`` layers (a
    hybrid to ``layers`` groups of its mamba layers and the shared
    block; an encoder to ``layers`` layers too)."""
    def cut(arch_id):
        cfg = get_config(arch_id)
        n = (layers * (cfg.hybrid_group + 1) if cfg.family == "hybrid"
             else layers)
        kw = {"n_layers": n}
        if cfg.encoder_layers:
            kw["encoder_layers"] = layers
        return dataclasses.replace(cfg, **kw)
    return cut


def _frames(frame):
    """(file, function, line) a frame, innermost first; a dispatch
    mode's ``__torch_dispatch__`` is named by its class."""
    out = []
    for f, line in traceback.walk_stack(frame):
        name = f.f_code.co_name
        if name == "__torch_dispatch__":
            name = type(f.f_locals.get("self")).__name__
        out.append((f.f_code.co_filename, name, line))
    return out


def sample(fn, every: float, seconds: int):
    """(fn's result or None if stopped, wall s, the samples: each the
    main thread's stack, innermost first)."""
    main = threading.get_ident()
    samples, stop = [], threading.Event()

    def run():
        while not stop.wait(every):
            frame = sys._current_frames().get(main)
            if frame is not None:
                samples.append(_frames(frame))
    thread = threading.Thread(target=run, daemon=True)

    def alarm(signum, frame):
        raise _Stop
    signal.signal(signal.SIGALRM, alarm)
    res, t0 = None, time.monotonic()
    thread.start()
    signal.alarm(seconds)
    try:
        res = fn()
    except _Stop:
        pass
    finally:
        signal.alarm(0)
        stop.set()
        thread.join()
    return res, time.monotonic() - t0, samples


def _mode(frames) -> str | None:
    """The dispatch mode whose ``__torch_dispatch__`` is the innermost
    frame of the port in a sample, if any."""
    for path, name, _ in frames:
        if "repro_torch" in path:
            return name if name in MODES else None
    return None


def report(samples, wall: float, top: int) -> None:
    n = max(len(samples), 1)
    for label, (suffix, name) in SPLIT.items():
        k = sum(any(p.endswith(suffix) and f == name for p, f, _ in s)
                for s in samples)
        print(f"  {label:42s} {k / n:6.1%}  ~{wall * k / n:7.1f} s")
    modes = collections.Counter(_mode(s) for s in samples)
    for mode in MODES:
        print(f"  {mode + ' (own frames)':42s} {modes[mode] / n:6.1%}  "
              f"~{wall * modes[mode] / n:7.1f} s")
    inner = collections.Counter()
    for s in samples:
        for path, name, line in s:
            if "repro_torch" in path:
                inner[(path.split("repro_torch/")[-1], line, name)] += 1
                break
    print(f"innermost frames of the port ({len(samples)} samples):")
    for (path, line, name), k in inner.most_common(top):
        print(f"  {k / n:6.1%}  {path}:{line} {name}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="multi", choices=["single", "multi"])
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--seconds", type=int, default=0)
    ap.add_argument("--every", type=float, default=0.25)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)

    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._redistribute import _gen_transform_infos

    from repro_torch.launch import dryrun as D
    if args.layers:
        D.get_config = cut_config(D.get_config, args.layers)
    res, wall, samples = sample(
        lambda: D.lower_cell(args.arch, args.shape, args.mesh == "multi"),
        args.every, args.seconds)
    status = "stopped" if res is None else res["status"]
    prop = DTensor._op_dispatcher.sharding_propagator \
        .propagate_op_sharding.cache_info()
    plans = _gen_transform_infos.cache_info()
    print(f"cell {args.arch} {args.shape} {args.mesh} layers="
          f"{args.layers or 'all'} ({args.src}): {status} after {wall:.1f} "
          f"s wall on the CPU"
          + ("" if res is None else f" (trace_s {res['trace_s']})"))
    print(f"propagation cache: {prop.hits} hits, {prop.misses} misses; "
          f"redistribute plans: {plans.misses} computed, {plans.hits} "
          f"reused")
    report(samples, wall, args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
