"""Multi-pod dry run: trace one rank's step of every (architecture x
input shape x mesh) cell over a fake 256- or 512-rank world, measure its
memory and collectives, derive roofline terms.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b \\
      --shape train_4k --mesh single --out results/dryrun
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

No device memory is touched, and no card is needed.  The world is a
``fake`` process group of 256 (single pod) or 512 (multi-pod) ranks
(``launch.mesh.fake_world``) with this process as rank 0, and the mesh
comes from ``launch.mesh`` (``make_production_mesh`` or
``make_moe_mesh``, as ``dist.sharding.resolve_profile`` says) on device
type ``cpu``.  Parameters, optimizer state, batch and cache are
``meta`` DTensors placed by the rule tables; the cell's step
(``make_train_step``, ``Model.prefill`` or ``Model.decode_step``) runs
once on them with ``kernel_impl="plain"`` (the hand-written kernels are
ctypes calls that no counter sees), under
``roofline.counters.count_collectives``, which counts this rank's
collectives per execution (no trip counts to recover) and its FLOPs,
and under ``roofline.counters.MemoryTracker``, which follows the live
bytes of every local storage and keeps the peak (the stand-in for
``torch.distributed._tools.mem_tracker.MemTracker``, which counts
DTensor's fake global-shape tensors as memory).  A
cell failing here (a placement DTensor cannot propagate, a collective a
fake group lacks) is a bug in the system, not in the cell.

The result has the JAX package's keys where their meaning carries over.
Three changed:

* ``collective_bytes_flat_hlo`` -> ``collective_bytes_counted``: the
  bytes counted at run time (the JAX package also parses the compiled
  HLO flat, without loop trip counts; a PyTorch step has no HLO);
* ``lower_s`` / ``compile_s`` -> ``trace_s``: one traced execution,
  nothing is compiled;
* ``fits_16GB`` (a TPU v5e's HBM) -> ``fits_hbm``: the peak against the
  H100's 80 GB (``roofline.analysis.HW["hbm_bytes"]``).

Memory, per rank: ``argument_bytes_per_dev`` the local bytes of the
step's inputs (state or parameters, batch, cache) that it reads, as
the JAX package's ``jax.jit`` keeps only those; ``peak_bytes_per_dev``
the tracker's peak of live local bytes, those inputs included;
``temp_bytes_per_dev`` the peak less the inputs; ``output_bytes_per_dev``
the outputs' local bytes in storages the inputs do not hold;
``alias_bytes_per_dev`` the inputs updated in place (the train state,
the decode cache: the JAX package donates them).  ``cost`` holds this
rank's counted FLOPs (XLA's ``cost_analysis`` per device in the JAX
package).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import SHAPES, applicable, get_config
from repro_torch.dist.api import ShardingContext, use_sharding
from repro_torch.dist.sharding import (param_specs_tree, placements_for,
                                       resolve_profile, spec_for)
from repro_torch.launch.mesh import (fake_world, make_moe_mesh,
                                     make_production_mesh)
from repro_torch.models import build_model
from repro_torch.roofline.analysis import HW, roofline_report
from repro_torch.roofline.analytic import analytic_bytes, analytic_flops
from repro_torch.roofline.counters import (MemoryTracker, count_collectives,
                                          storage_key)
from repro_torch.train import (OptConfig, TrainConfig,
                               make_train_state_specs, make_train_step,
                               pick_optimizer)
from repro_torch.train.optimizer import _leaves, _tree_map

__all__ = ["lower_cell", "main"]

# ranks of the fake world: one pod, two pods
WORLD = {False: 256, True: 512}


def _place(t, mesh, placements):
    """``t`` (a meta tensor) as a DTensor over ``mesh``: each rank's
    local meta shard, nothing allocated."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, placements, src_data_rank=None)


def _placed(abstract, axes, ctx):
    """A tree of meta tensors placed by ``ctx.act_rules`` for their
    logical axes (a batch or a cache)."""
    return _tree_map(lambda a, ax: _place(a, ctx.mesh, placements_for(
        spec_for(tuple(a.shape), ax, ctx.act_rules, ctx.mesh), ctx.mesh)),
        abstract, axes)


def _meta(spec: dict) -> dict:
    """A cache spec {name: (shape, dtype)} as meta tensors."""
    return {n: torch.empty(shape, dtype=dt, device="meta")
            for n, (shape, dt) in spec.items()}


def _local_bytes(tree) -> int:
    """Local bytes of a tree's DTensor (or plain) leaves, each storage
    once."""
    seen, total = set(), 0
    for t in (_leaves(tree) if isinstance(tree, dict) else tree):
        key = storage_key(t)
        if key not in seen:
            seen.add(key)
            total += getattr(t, "_local_tensor", t).untyped_storage().nbytes()
    return total


def _leaf_list(*trees) -> list:
    out = []
    for t in trees:
        if isinstance(t, dict):
            out.extend(_leaves(t))
        elif isinstance(t, (tuple, list)):
            out.extend(_leaf_list(*t))
        elif isinstance(t, torch.Tensor):
            out.append(t)
    return out


def _run_cell(model, cfg, shape, ctx, overrides):
    """Place the cell's inputs, run its step once under the counters.
    Returns (inputs, outputs, collectives, FLOPs, peak bytes, donated
    inputs, extra keys, tokens per step), the inputs and the peak those
    the step reads (``_read``)."""
    mesh = ctx.mesh
    batch_abs, batch_axes = model.input_specs(shape)
    batch = _placed(batch_abs, batch_axes, ctx)
    extra, donated = {}, []
    if shape.kind == "train":
        n_params = cfg.n_params()
        opt_name = pick_optimizer(n_params)
        param_dtype = torch.bfloat16 if n_params > 100e9 else torch.float32
        tcfg = TrainConfig(opt=OptConfig(name=opt_name),
                           remat_policy=overrides.get("remat_policy",
                                                      "full"))
        abstract, placements = make_train_state_specs(model, tcfg, ctx)
        if param_dtype != torch.float32:
            abstract["params"] = _tree_map(
                lambda a: torch.empty(a.shape, dtype=param_dtype,
                                      device="meta"), abstract["params"])
        state = _tree_map(lambda a, pl: _place(a, mesh, pl), abstract,
                          placements)
        inputs, donated = (state, batch), [state]
        step = make_train_step(model, tcfg)

        def fn():
            return step(state, batch)
        extra = {"optimizer": opt_name,
                 "param_dtype": str(param_dtype).removeprefix("torch.")}
        tokens = shape.global_batch * shape.seq_len
    else:
        ap = model.abstract_params(torch.bfloat16)
        specs = param_specs_tree(model.param_axes(), ap, mesh,
                                 ctx.param_rules)
        params = _tree_map(lambda a, s: _place(
            a, mesh, placements_for(s, mesh)), ap, specs)
        cache_spec, cache_axes = model.cache_spec(shape.global_batch,
                                                  shape.seq_len)
        # the reference pins the output cache's (and logits') sharding
        cache_pl = _tree_map(lambda a, ax: placements_for(spec_for(
            tuple(a.shape), ax, ctx.act_rules, mesh), mesh),
            _meta(cache_spec), cache_axes)

        def pin(cache):
            return {n: c.redistribute(mesh, cache_pl[n])
                    for n, c in cache.items()}
        if shape.kind == "prefill":
            inputs = (params, batch)
            logit_pl = placements_for(spec_for(
                (shape.global_batch, 1, cfg.padded_vocab),
                ("batch", "seq", "vocab"), ctx.act_rules, mesh), mesh)

            def fn():
                logits, cache = model.prefill(params, batch)
                return logits.redistribute(mesh, logit_pl), pin(cache)
            tokens = shape.global_batch * shape.seq_len
        else:
            cache = _placed(_meta(cache_spec), cache_axes, ctx)
            inputs, donated = (params, cache, batch), [cache]

            def fn():
                nxt, new = model.decode_step(params, cache, batch["tokens"],
                                             batch["pos"])
                return nxt.redistribute(mesh, placements_for((), mesh)), \
                    pin(new)
            tokens = shape.global_batch
    in_leaves = _leaf_list(*inputs)
    tracker = MemoryTracker()
    tracker.track(*in_leaves)
    with use_sharding(ctx), tracker, torch.set_grad_enabled(
            shape.kind == "train"):
        out, coll, flops = count_collectives(fn)
    out = _leaf_list(out)
    read = _read(in_leaves, out, tracker.read)
    # an unread input is live from the step's start to its end
    peak = tracker.peak - (_local_bytes(in_leaves) - _local_bytes(read))
    return (read, out, coll, flops, peak,
            _read(_leaf_list(*donated), out, tracker.read), extra, tokens)


def _read(inputs, outputs, read) -> list:
    """The ``inputs`` whose storage an operator of the step read (keys
    ``read``) or an output holds.  The JAX package's ``jax.jit`` drops
    the others from the compiled step (``keep_unused=False``), and so
    from its argument bytes: an ssm's decode ignores the positions,
    whisper's decode the encoder, the vlm's prefill the token table."""
    keep = read | {storage_key(t) for t in outputs}
    return [t for t in inputs if storage_key(t) in keep]


def lower_cell(arch_id: str, shape_id: str, multi_pod: bool,
               overrides: dict | None = None,
               profile: str = "baseline") -> dict:
    cfg = get_config(arch_id)
    shape = SHAPES[shape_id]
    ok, why = applicable(cfg, shape)
    if not ok:
        return {"arch": arch_id, "shape": shape_id,
                "mesh": "multi" if multi_pod else "single",
                "status": "skipped", "reason": why, "profile": profile}
    if dist.is_initialized():
        raise RuntimeError("the dry run builds its own fake world: call it "
                           "with no process group initialised")

    overrides = overrides or {}
    a_rules, p_rules, mesh_kind = resolve_profile(profile, cfg, shape.kind,
                                                  multi_pod)
    model = build_model(cfg, kernel_impl="plain")
    with fake_world(WORLD[multi_pod]):
        mesh = (make_moe_mesh(multi_pod=multi_pod, device="cpu")
                if mesh_kind == "moe"
                else make_production_mesh(multi_pod=multi_pod, device="cpu"))
        n_chips = mesh.size()
        ctx = ShardingContext(mesh, a_rules, p_rules)
        if "act_rules" in overrides:
            ctx.act_rules = {**ctx.act_rules, **overrides["act_rules"]}
        if "param_rules" in overrides:
            ctx.param_rules = {**ctx.param_rules, **overrides["param_rules"]}
        t0 = time.monotonic()
        inputs, outputs, coll, flops, peak, donated, extra, tokens = \
            _run_cell(model, cfg, shape, ctx, overrides)
        t_trace = time.monotonic() - t0

    arg_bytes = _local_bytes(inputs)
    in_storages = {storage_key(t) for t in inputs}
    out_bytes = _local_bytes([t for t in outputs
                              if storage_key(t) not in in_storages])
    alias_bytes = _local_bytes(donated)

    # analytic compute/memory terms, as the JAX package's
    af = analytic_flops(cfg, shape,
                        overrides.get("remat_policy", "full")
                        if shape.kind == "train" else None)
    ab = analytic_bytes(cfg, shape)
    report = roofline_report(
        flops_per_dev=af["compiled"] / n_chips,
        bytes_per_dev=ab["traffic"] / n_chips,
        coll=coll, n_chips=n_chips, model_flops_total=af["model_flops"])
    report["collective_bytes_counted"] = coll.total_bytes
    report["analytic"] = {**af, **ab}
    if shape.kind == "decode":
        # decode is memory-bound by physics: how close the step's lower
        # bound sits to the floor of reading the weights + the KV/SSM
        # state once per token
        floor = (ab["param_store"] + ab["cache_bytes"]) / n_chips \
            / HW["hbm_bw"]
        report["irreducible_bytes_floor_s"] = floor
        report["decode_bw_fraction"] = (
            floor / report["step_lower_bound_s"]
            if report["step_lower_bound_s"] else 0.0)

    return {
        "arch": arch_id, "shape": shape_id,
        "mesh": "multi" if multi_pod else "single",
        "profile": profile,
        "status": "ok",
        "n_chips": n_chips,
        "n_params": cfg.n_params(),
        "n_active_params": cfg.n_active_params(),
        "tokens_per_step": tokens,
        "trace_s": round(t_trace, 1),
        "memory": {
            "argument_bytes_per_dev": arg_bytes,
            "output_bytes_per_dev": out_bytes,
            "temp_bytes_per_dev": peak - arg_bytes,
            "peak_bytes_per_dev": peak,
            "alias_bytes_per_dev": alias_bytes,
            "fits_hbm": bool(peak < HW["hbm_bytes"]),
        },
        "cost": {"flops": flops},
        "roofline": report,
        **extra,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--remat", default=None)
    ap.add_argument("--profile", default="baseline",
                    choices=["baseline", "opt"])
    args = ap.parse_args(argv)

    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    cells = []
    if args.all:
        from repro_torch.configs import ARCH_IDS
        for a in ARCH_IDS:
            for s in SHAPES:
                cells.append((a, s))
    else:
        cells.append((args.arch, args.shape))

    overrides = {}
    if args.remat:
        overrides["remat_policy"] = args.remat

    rc = 0
    for arch_id, shape_id in cells:
        for mp in meshes:
            tag = f"{arch_id}__{shape_id}__{'multi' if mp else 'single'}"
            path = outdir / f"{tag}.json"
            try:
                res = lower_cell(arch_id, shape_id, mp, overrides,
                                 profile=args.profile)
            except (ValueError, TypeError, KeyError, RuntimeError,
                    NotImplementedError, OSError) as e:
                # the failure modes a traced step produces (bad
                # config/shape, a placement DTensor cannot propagate, a
                # collective the fake group lacks, filesystem errors);
                # genuine programming errors still crash the sweep cell
                res = {"arch": arch_id, "shape": shape_id,
                       "mesh": "multi" if mp else "single",
                       "status": "error", "error": f"{type(e).__name__}: "
                                                   f"{e}",
                       "traceback": traceback.format_exc()[-4000:]}
                print(f"[error  ] {tag}  {type(e).__name__}: {e}",
                      flush=True)
                rc = 1
            path.write_text(json.dumps(res, indent=2, default=str))
            status = res["status"]
            peak = res.get("memory", {}).get("peak_bytes_per_dev", 0)
            dom = res.get("roofline", {}).get("dominant", "-")
            frac = res.get("roofline", {}).get("roofline_fraction", 0)
            print(f"[{status:7s}] {tag}  peak={peak/1e9:.2f}GB  "
                  f"dominant={dom}  roofline_frac={frac:.3f}",
                  flush=True)
            if status == "ok":
                print("  memory:", res["memory"], flush=True)
                print("  cost:", res["cost"], flush=True)
                print("  collectives:",
                      res["roofline"]["collective_bytes_by_op"], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
