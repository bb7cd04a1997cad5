#!/usr/bin/env python3
"""Tables over dry-run result directories (one JSON a cell, as
``launch.sweep`` writes them; the JAX package's sweep writes the same
names and keys).

    python3 scripts/dryrun_table.py cells REF_MULTI PORT_MULTI PORT_SINGLE [PARENT_MULTI]
    python3 scripts/dryrun_table.py against MESH REF PORT [PARENT]
    python3 scripts/dryrun_table.py compare BEFORE AFTER

``cells``: one markdown row per (arch x shape) cell of the multi-pod
sweep: the status on both sides (with a skip's reason), the per-rank
argument bytes on both sides, the port's ``trace_s``, its single-pod
twin's and their ratio, the port's peak GB a rank and ``fits_hbm``;
then a summary (statuses equal, argument bytes equal where both are
ok, the largest ratio, the slowest cell), then the ``against`` table
of the multi-pod cells.  Exits 1 if a status, a skip's reason or
argument bytes differ.

``against``: for every cell of mesh MESH (single or multi) ok in both
REF (the JAX package's sweep) and PORT, the counted FLOPs a device and
the collective bytes a device, on both sides and, given PARENT (an
earlier port sweep), on its side too: the FLOPs also as a multiple of
the analytic count a device (``roofline.analytic.compiled`` over the
chips), the bytes summed over the ops and by op (AG all-gather, AR
all-reduce, RS reduce-scatter, A2A all-to-all, CP collective-permute).
A figure moved toward the reference where PORT's is nearer REF's than
PARENT's on a log scale (by more than 1%), away where it is farther;
then the counts of each.  FLOPs are held to the analytic count
instead: the reference's are XLA's cost analysis, which counts a
scanned loop's body once (the reference's roofline takes the analytic
count for that reason; its collective bytes count each loop's trips).

``compare``: for every cell ok in both directories, whether the report
changed: argument and peak bytes, counted FLOPs, collective bytes and
counts by op; one line a cell, the changed figures as before -> after
(relative change), and the trace times.
"""

from __future__ import annotations

import json
import pathlib
import sys

ARCHS = ["internlm2-1.8b", "gemma2-2b", "mamba2-2.7b", "phi4-mini-3.8b",
         "zamba2-7b", "phi3-medium-14b", "whisper-large-v3",
         "phi3.5-moe-42b-a6.6b", "qwen2-vl-72b", "grok-1-314b"]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]

def load(d: pathlib.Path, arch: str, shape: str, mesh: str):
    path = d / f"{arch}__{shape}__{mesh}.json"
    if not path.exists():
        return {"status": "missing"}
    return json.loads(path.read_text())


def _status(r) -> str:
    if r["status"] == "skipped":
        return "skipped"
    if r["status"] == "error":
        return f"error ({r.get('error', '')[:40]})"
    return r["status"]


def cells(ref_dir, multi_dir, single_dir, parent_dir=None) -> int:
    print("| cell | reference | port | arg bytes, reference | arg bytes, "
          "port | trace_s multi | trace_s single | ratio | peak GB | "
          "fits_hbm |")
    print("|---|---|---|---:|---:|---:|---:|---:|---:|---|")
    bad, ratios, times, reasons = [], [], [], {}
    for arch in ARCHS:
        for shape in SHAPES:
            ref = load(ref_dir, arch, shape, "multi")
            port = load(multi_dir, arch, shape, "multi")
            twin = load(single_dir, arch, shape, "single")
            ok = ref["status"] == "ok" and port["status"] == "ok"
            a_ref = ref.get("memory", {}).get("argument_bytes_per_dev")
            a_port = port.get("memory", {}).get("argument_bytes_per_dev")
            if ok and a_ref != a_port:
                bad.append(f"{arch} {shape}")
            if ref["status"] != port["status"]:
                bad.append(f"{arch} {shape}")
            if port["status"] == "skipped":
                reasons[port.get("reason")] = (
                    reasons.get(port.get("reason"), 0) + 1)
                if port.get("reason") != ref.get("reason"):
                    bad.append(f"{arch} {shape} (reason)")
            t, t1 = port.get("trace_s"), twin.get("trace_s")
            ratio = t / t1 if t is not None and t1 else None
            if ratio is not None:
                ratios.append((ratio, f"{arch} {shape}"))
            if t is not None:
                times.append((t, f"{arch} {shape}"))
            mem = port.get("memory", {})
            peak = mem.get("peak_bytes_per_dev")

            def fmt(v, f="{:,}"):
                return "-" if v is None else f.format(v)
            print(f"| {arch} {shape} | {_status(ref)} | {_status(port)} | "
                  f"{fmt(a_ref)} | {fmt(a_port)} | {fmt(t)} | {fmt(t1)} | "
                  f"{fmt(ratio, '{:.2f}')} | "
                  f"{fmt(None if peak is None else peak / 1e9, '{:.2f}')}"
                  f" | {mem.get('fits_hbm', '-')} |")
    n = {s: sum(load(multi_dir, a, sh, "multi")["status"] == s
                for a in ARCHS for sh in SHAPES)
         for s in ("ok", "skipped", "error", "missing")}
    print(f"\nport: {n}; skip reasons: {reasons}")
    if ratios:
        r, c = max(ratios)
        print(f"largest multi/single trace ratio {r:.2f} ({c})")
    if times:
        t, c = max(times)
        print(f"slowest multi cell {t} s ({c}); sum of trace_s "
              f"{sum(v for v, _ in times):.1f} s")
    print("differences from the reference: " + (", ".join(bad) or "none"))
    against("multi", ref_dir, multi_dir, parent_dir)
    return 1 if bad else 0


OPS = {"all-gather": "AG", "all-reduce": "AR", "reduce-scatter": "RS",
       "all-to-all": "A2A", "collective-permute": "CP"}


def _figures(r):
    """(FLOPs a device, their multiple of the analytic count, collective
    bytes a device by op) of an ok report."""
    an = r["roofline"]["analytic"]["compiled"] / r["n_chips"]
    return (r["cost"]["flops"], r["cost"]["flops"] / an,
            r["roofline"]["collective_bytes_by_op"])


def _toward(ref, parent, port) -> str:
    """Whether ``port`` moved toward ``ref`` from ``parent`` (log scale;
    a zero is taken as one byte)."""
    import math
    if parent is None:
        return "new"
    d0, d1 = (abs(math.log((max(v, 1.0)) / max(ref, 1.0)))
              for v in (parent, port))
    return ("toward" if d1 < d0 - 0.01 else "away" if d1 > d0 + 0.01
            else "same")


def against(mesh, ref_dir, port_dir, parent_dir=None) -> int:
    print(f"\n{mesh}-pod cells ok in the reference and the port: FLOPs a "
          "device (x the analytic count) and collective bytes a device, "
          "reference / " + ("parent / " if parent_dir else "") + "port")
    print("| cell | FLOPs | FLOPs moved | collective bytes | bytes moved | "
          "by op |")
    print("|---|---|---|---|---|---|")
    tally = {}
    for arch in ARCHS:
        for shape in SHAPES:
            ref = load(ref_dir, arch, shape, mesh)
            port = load(port_dir, arch, shape, mesh)
            if ref["status"] != "ok" or port["status"] != "ok":
                continue
            par = (load(parent_dir, arch, shape, mesh) if parent_dir
                   else {"status": "missing"})
            sides = [_figures(ref)] + ([_figures(par)] if par["status"]
                                       == "ok" else [None] * bool(
                                           parent_dir)) + [_figures(port)]
            fl = " / ".join("-" if f is None else f"{f[0]:.3g} ({f[1]:.2f}x)"
                            for f in sides)
            tot = [None if f is None else sum(f[2].values()) for f in sides]
            by = ", ".join(
                f"{OPS.get(op, op)} " + " / ".join(
                    "-" if f is None else f"{f[2].get(op, 0):.3g}"
                    for f in sides)
                for op in OPS if any(f and op in f[2] for f in sides))
            # FLOPs against the analytic count: the reference's own
            # count is XLA's cost analysis, which takes a scanned loop's
            # body once (its roofline uses the analytic count)
            moved = [_toward(1.0, sides[1] and sides[1][1], sides[-1][1])
                     if parent_dir else "-"]
            moved.append(_toward(tot[0], tot[1], tot[-1]) if parent_dir
                         else "-")
            for k, m in zip(("flops", "bytes"), moved):
                tally[(k, m)] = tally.get((k, m), 0) + 1
            print(f"| {arch} {shape} | {fl} | {moved[0]} | "
                  + " / ".join("-" if t is None else f"{t:.3g}" for t in tot)
                  + f" | {moved[1]} | {by} |")
    if parent_dir:
        for k in ("flops", "bytes"):
            print(f"{k}: " + ", ".join(f"{m} {n}" for (kk, m), n in
                                       sorted(tally.items()) if kk == k))
    return 0


def _rel(a, b) -> str:
    return f"{a:.6g} -> {b:.6g} ({(b - a) / a:+.1%})" if a else \
        f"{a} -> {b}"


def compare(before, after) -> int:
    for mesh in ("single", "multi"):
        for arch in ARCHS:
            for shape in SHAPES:
                a = load(before, arch, shape, mesh)
                b = load(after, arch, shape, mesh)
                tag = f"{arch} {shape} {mesh}"
                if a["status"] != "ok" or b["status"] != "ok":
                    if "missing" not in (a["status"], b["status"]):
                        print(f"{tag}: {_status(a)} -> {_status(b)}")
                    continue
                diffs = []
                for k in ("argument_bytes_per_dev", "peak_bytes_per_dev"):
                    if a["memory"][k] != b["memory"][k]:
                        diffs.append(f"{k} {_rel(a['memory'][k], b['memory'][k])}")
                if a["memory"]["fits_hbm"] != b["memory"]["fits_hbm"]:
                    diffs.append(f"fits_hbm {a['memory']['fits_hbm']} -> "
                                 f"{b['memory']['fits_hbm']}")
                if a["cost"]["flops"] != b["cost"]["flops"]:
                    diffs.append(f"flops {_rel(a['cost']['flops'], b['cost']['flops'])}")
                ca, cb = (r["roofline"]["collective_bytes_by_op"]
                          for r in (a, b))
                for op in sorted(set(ca) | set(cb)):
                    if ca.get(op, 0) != cb.get(op, 0):
                        diffs.append(f"{op} bytes {_rel(ca.get(op, 0), cb.get(op, 0))}")
                na, nb = (r["roofline"]["collective_count_by_op"]
                          for r in (a, b))
                if na != nb:
                    diffs.append(f"counts {na} -> {nb}")
                print(f"{tag}: trace_s {a['trace_s']} -> {b['trace_s']}; "
                      + ("same report" if not diffs else "; ".join(diffs)))
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "cells" and len(argv) in (4, 5):
        return cells(*map(pathlib.Path, argv[1:]))
    if argv and argv[0] == "against" and len(argv) in (4, 5) and \
            argv[1] in ("single", "multi"):
        return against(argv[1], *map(pathlib.Path, argv[2:]))
    if argv and argv[0] == "compare" and len(argv) == 3:
        return compare(*map(pathlib.Path, argv[1:]))
    print(__doc__)
    return 2


if __name__ == "__main__":
    sys.exit(main())
