"""CLI: ``python -m repro_torch.analysis [paths...]``.

Exit codes: 0 clean (or fully baselined), 1 unbaselined findings,
2 usage error.  ``--write-baseline`` records the current findings as
the new baseline — each entry then carries a ``justification`` field
to be filled in with a written reason (the default ``TODO`` text says
so).
"""
from __future__ import annotations

import argparse
import os
import sys

from . import ALL_CHECKERS, Baseline, run_analysis

DEFAULT_BASELINE = os.path.join(os.path.dirname(__file__),
                                "baseline.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Contract analyzer: lock order, layering, benign "
                    "races, jit retrace/donation, style.")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files or directories to scan (default: the "
                         "repro_torch package this module was loaded from)")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline JSON path (default: the package's "
                         "baseline.json)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept the current findings as the baseline")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline: report everything")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="summary line only")
    args = ap.parse_args(argv)

    paths = args.paths or [os.path.dirname(os.path.dirname(__file__))]
    for p in paths:
        if not os.path.exists(p):
            print(f"error: no such path: {p}", file=sys.stderr)
            return 2

    findings = run_analysis(paths)
    baseline = Baseline() if args.no_baseline \
        else Baseline.load(args.baseline)

    if args.write_baseline:
        baseline.save(args.baseline, findings)
        print(f"wrote {len(findings)} finding(s) to {args.baseline}")
        return 0

    new, old, stale = baseline.split(findings)
    if not args.quiet:
        for f in new:
            print(f.render())
        for fp in stale:
            print(f"stale baseline entry {fp}: finding no longer "
                  f"exists — remove it")
    checkers = ", ".join(c.name for c in ALL_CHECKERS)
    print(f"repro_torch.analysis: {len(findings)} finding(s) "
          f"({len(new)} new, {len(old)} baselined, {len(stale)} stale "
          f"baseline entr{'y' if len(stale) == 1 else 'ies'}) "
          f"across [{checkers}]")
    return 1 if new or stale else 0


if __name__ == "__main__":
    sys.exit(main())
