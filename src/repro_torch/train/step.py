"""Train-step builder: loss and gradients -> clip -> optimizer, as one
function over a {params, opt, step} state dict.

The JAX package jits ``value_and_grad`` of the loss; here autograd takes
the gradients of the model's loss, accumulated over microbatches in the
parameters' ``.grad``, and the step updates the state in place (the JAX
package's trainer donates it).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.api import Model
from repro_torch.train.optimizer import (OptConfig, _const, _leaves,
                                         _tree_map, abstract_opt_state,
                                         clip_by_global_norm, lr_schedule,
                                         opt_state_axes, opt_update)

__all__ = ["TrainConfig", "make_train_step", "make_train_state_specs"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    remat_policy: Optional[str] = "dots"
    microbatches: int = 1            # grad accumulation


def make_train_step(model: Model, tcfg: TrainConfig):
    """``train_step(state, batch) -> (state, metrics)``.  ``batch`` holds
    (B, S) tensors ("tokens" or "embeds", "targets") on the parameters'
    device; with ``microbatches`` n it is cut into n rows-blocks whose
    gradients are summed and divided by n, the loss averaged and the
    other metrics taken from the last.  Metrics are 0-d tensors: loss,
    grad_norm, lr, ce and aux.  ``state`` is updated in place."""
    ocfg = tcfg.opt

    def train_step(state, batch):
        params, opt, step = state["params"], state["opt"], state["step"]
        leaves = _leaves(params)
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        n = tcfg.microbatches
        mbs = ([{k: v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)]
                 for k, v in batch.items()} for i in range(n)]
               if n > 1 else [batch])
        loss = torch.zeros((), dtype=torch.float32, device=step.device)
        for mb in mbs:
            l_i, metrics = model.loss(params, mb,
                                      remat_policy=tcfg.remat_policy)
            l_i.backward()
            loss = loss + l_i.detach()
        grads = _tree_map(lambda p: (p.grad if p.grad is not None
                                     else torch.zeros_like(p)), params)
        if n > 1:
            div = _const(float(n), loss)
            loss = loss / div
            grads = _tree_map(lambda g: g / div, grads)
        for p in leaves:
            p.grad = None
            p.requires_grad_(False)
        # a DTensor gradient's pending partial sums reduced once, onto
        # its parameter's placements (FSDP's reduce-scatter), before the
        # norm and the update read it
        grads = _tree_map(lambda g, p: (g.redistribute(p.device_mesh,
                                                       p.placements)
                                        if isinstance(g, DTensor) else g),
                          grads, params)
        grads, gnorm = clip_by_global_norm(grads, ocfg.clip_norm)
        opt_update(ocfg.name, ocfg, params, grads, opt, step)
        del grads
        new_state = {"params": params, "opt": opt, "step": step + 1}
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(loss=loss, grad_norm=gnorm,
                       lr=lr_schedule(ocfg, step))
        return new_state, metrics

    return train_step


def make_train_state_specs(model: Model, tcfg: TrainConfig, ctx):
    """(abstract_state, placements_tree) for a sharded init: the state
    {params, opt, step} as ``meta`` tensors (float32 parameters, the
    optimizer's moments, an int32 step), and each leaf's DTensor
    placements over ``ctx.mesh`` (a ``DeviceMesh`` with named dims) by
    ``ctx.param_rules``."""
    from repro_torch.dist.sharding import (PartitionSpec, param_specs_tree,
                                           placements_for)

    ap = model.abstract_params(torch.float32)
    axes = model.param_axes()
    opt_abs = _tree_map(
        lambda sd: torch.empty(sd[0], dtype=sd[1], device="meta"),
        abstract_opt_state(tcfg.opt.name, ap))
    opt_axes = opt_state_axes(tcfg.opt.name, axes)

    abstract = {"params": ap, "opt": opt_abs,
                "step": torch.empty((), dtype=torch.int32, device="meta")}
    p_specs = param_specs_tree(axes, ap, ctx.mesh, ctx.param_rules)
    o_specs = param_specs_tree(opt_axes, opt_abs, ctx.mesh,
                               ctx.param_rules)
    to_pl = lambda spec: placements_for(spec, ctx.mesh)      # noqa: E731
    placements = {
        "params": _tree_map(to_pl, p_specs),
        "opt": _tree_map(to_pl, o_specs),
        "step": placements_for(PartitionSpec(), ctx.mesh),
    }
    return abstract, placements
