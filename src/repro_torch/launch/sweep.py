"""Full dry-run sweep: every (arch x shape x mesh) cell in its own
``python -m repro_torch.launch.dryrun`` subprocess (each traces in a
fresh process: the fake world is process-global; and the sweep can
resume).  Cells with an existing ``ok`` or ``skipped`` result JSON are
skipped, so the sweep can be re-run incrementally; an unreadable result
is re-run.  No card is needed.

  PYTHONPATH=src python -m repro_torch.launch.sweep --out results/dryrun
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

__all__ = ["main"]

# rough cost ordering: small archs first so results accumulate early
_SIZE_ORDER = [
    "internlm2-1.8b", "gemma2-2b", "mamba2-2.7b", "phi4-mini-3.8b",
    "zamba2-7b", "phi3-medium-14b", "whisper-large-v3",
    "phi3.5-moe-42b-a6.6b", "qwen2-vl-72b", "grok-1-314b",
]
_SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--timeout", type=float, default=3600.0)
    ap.add_argument("--profile", default="baseline")
    args = ap.parse_args(argv)

    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]

    cells = [(a, s, m) for m in meshes for a in _SIZE_ORDER
             for s in _SHAPE_ORDER]
    t_start = time.monotonic()
    n_ok = n_fail = n_skip = 0
    for arch, shape, mesh in cells:
        tag = f"{arch}__{shape}__{mesh}"
        path = outdir / f"{tag}.json"
        if path.exists():
            try:
                status = json.loads(path.read_text()).get("status")
            except (OSError, json.JSONDecodeError, AttributeError) as exc:
                # unreadable/corrupt result JSON (AttributeError: a
                # non-dict payload): log and re-run the cell
                print(f"[sweep] unreadable result {path}: "
                      f"{type(exc).__name__}: {exc} — re-running",
                      flush=True)
                status = None
            if status in ("ok", "skipped"):
                n_skip += 1
                continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--mesh", mesh,
               "--out", str(outdir), "--profile", args.profile]
        t0 = time.monotonic()
        try:
            p = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=args.timeout)
            out_tail = (p.stdout or "")[-2000:]
            ok = "[ok " in out_tail or "[skipped" in out_tail
        except subprocess.TimeoutExpired:
            ok = False
            path.write_text(json.dumps(
                {"arch": arch, "shape": shape, "mesh": mesh,
                 "status": "error", "error": "trace timeout"}, indent=2))
        n_ok += ok
        n_fail += (not ok)
        print(f"[sweep {time.monotonic()-t_start:7.0f}s] {tag}: "
              f"{'ok' if ok else 'FAIL'} ({time.monotonic()-t0:.0f}s)",
              flush=True)
    print(f"[sweep done] ok={n_ok} fail={n_fail} skipped={n_skip} "
          f"total={time.monotonic()-t_start:.0f}s", flush=True)
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
