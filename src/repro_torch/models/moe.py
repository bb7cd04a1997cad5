"""Top-k MoE with sort-based token dispatch (GShard capacity semantics,
MegaBlocks-style compaction, no T x E one-hot blow-up), as the JAX
package's.

Dispatch is per batch row: each row's S*k (token, expert) slots are
sorted by expert id (a stable sort, so a token keeps its place among
the tokens of its expert), each slot gets its position within its
expert, slots past the capacity C go to a dump row, the kept ones fill a
dense (E, C, D) buffer per row, all experts run as one batched product,
and the outputs are read back, weighted by the router gates and
scatter-added to their tokens.  The expert products are batched over
the experts with every row's capacity slots side by side, (E, B*C, D).

Under a sharding context the dispatch buffer and the expert
activations are annotated with ``dist.api.constrain`` at the JAX
package's places.

``moe_block_ep`` is the JAX package's expert-parallel form: its
``shard_map`` body becomes explicit SPMD over ``torch.distributed``.
Each rank takes the local slices the reference's ``in_specs`` give it,
runs its local experts one by one on the tokens routed to each, and one
all-reduce over the ranks that share a data index sums the partial
outputs (see its docstring).  ``models.transformer`` takes it whenever
the active context's mesh has an ``expert`` axis.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.api import active_context, as_dtensor, constrain

__all__ = ["moe_param_defs", "moe_block", "router_aux_loss"]


def moe_param_defs(mk, prefix: str, cfg: ArchConfig, *, layers: int = 0):
    L = (layers,) if layers else ()
    lax_ = ("layers",) if layers else ()
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": mk(f"{prefix}.router", L + (d, e),
                     lax_ + ("d_model", "experts_router"), d),
        "w_up": mk(f"{prefix}.w_up", L + (e, d, f),
                   lax_ + ("experts", "d_model", "d_ff"), d),
        "w_down": mk(f"{prefix}.w_down", L + (e, f, d),
                     lax_ + ("experts", "d_ff", "d_model"), f),
    }
    if cfg.mlp_act in ("swiglu", "geglu"):
        p["w_gate"] = mk(f"{prefix}.w_gate", L + (e, d, f),
                         lax_ + ("experts", "d_model", "d_ff"), d)
    return p


def _capacity(cfg: ArchConfig, tokens_per_row: int) -> int:
    """Slots per expert and row: S k capacity_factor / E, at least 8 and
    padded to a multiple of 8 (the reference's TPU tiling)."""
    cap = int(tokens_per_row * cfg.n_experts_active
              * cfg.capacity_factor / cfg.n_experts)
    return max(8, ((cap + 7) // 8) * 8)


def _act(g, cfg: ArchConfig):
    return (F.silu(g) if cfg.mlp_act == "swiglu"
            else F.gelu(g, approximate="tanh"))


def _experts(buf, p, cfg: ArchConfig, compute_dtype, rows: int = 1):
    """buf (E, N, D) -> (E, N, D): each expert's MLP on its N slots, in
    the compute dtype.  Under a sharding context the hidden activations
    are annotated as the JAX package's (B, E, C, d_ff), N = ``rows`` *
    C."""
    def mm(a, w):
        return torch.bmm(a, w.to(compute_dtype))
    if cfg.mlp_act in ("swiglu", "geglu"):
        h = _act(mm(buf, p["w_gate"]), cfg) * mm(buf, p["w_up"])
    else:
        h = _act(mm(buf, p["w_up"]), cfg)
    if active_context() is not None:
        E, N, Fd = h.shape
        h = constrain(h.reshape(E, rows, N // rows, Fd).transpose(0, 1),
                      ("batch", "experts", "cap", "d_ff"))
        h = h.transpose(0, 1).reshape(E, N, Fd)
    return mm(h, p["w_down"])


def moe_block(x, p, cfg: ArchConfig, compute_dtype=torch.bfloat16):
    """x: (B, S, D) -> ((B, S, D) in the compute dtype, router probs
    (B, S, E) float32), top-k routed expert MLP.

    Per row: sort the S*k (token, expert) slots by expert id, compute
    each slot's position within its expert, drop beyond-capacity slots,
    scatter into a dense (E, C, D) buffer, run all experts as one
    batched product, and combine back with the router gates.
    """
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.n_experts_active
    C = _capacity(cfg, S)
    dev = x.device
    x = x.to(compute_dtype)

    # bf16 products are exact in float32: the reference's float32-
    # accumulated router product
    logits = x.float() @ p["router"].to(compute_dtype).float()
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, k, dim=-1)                # (B,S,k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    eflat = eidx.reshape(B, S * k)                            # expert / slot
    order = torch.argsort(eflat, dim=-1, stable=True)         # (B, S*k)
    sorted_e = torch.gather(eflat, 1, order)
    tok = order // k                                          # token / slot

    # position of each sorted slot within its expert
    counts = torch.zeros((B, E), dtype=torch.long, device=dev)
    counts.scatter_add_(1, sorted_e, torch.ones_like(sorted_e))
    starts = torch.cumsum(counts, dim=-1) - counts            # (B, E)
    pos = (torch.arange(S * k, device=dev)[None, :]
           - torch.gather(starts, 1, sorted_e))               # (B, S*k)
    slot = torch.where(pos < C, sorted_e * C + pos,
                       torch.full_like(pos, E * C))           # E*C = dump

    rows = torch.arange(B, device=dev)[:, None]
    xs = x[rows, tok]                                          # (B, S*k, D)
    buf = x.new_zeros((B, E * C + 1, D)).index_put((rows, slot), xs)
    buf = constrain(buf[:, :-1].reshape(B, E, C, D),
                    ("batch", "experts", "cap", "d_model"))
    buf = buf.transpose(0, 1)                                  # (E,B,C,D)
    y_e = _experts(buf.reshape(E, B * C, D), p, cfg, compute_dtype, B)
    y_e = y_e.reshape(E, B, C, D).transpose(0, 1).reshape(B, E * C, D)

    # combine: read each kept slot back, weight by its gate, scatter-add
    y_flat = torch.cat([y_e, y_e.new_zeros((B, 1, D))], dim=1)
    y_slots = y_flat[rows, slot]
    gate_sorted = torch.gather(gates.reshape(B, S * k), 1, order)
    y_slots = y_slots * gate_sorted[..., None].to(compute_dtype)
    y = x.new_zeros((B, S, D)).index_put((rows, tok), y_slots,
                                         accumulate=True)
    return y, probs


def _placements(mesh, **dims):
    """DTensor placements over ``mesh``: ``Shard(i)`` on the mesh dims
    named with tensor dim i, ``Partial()`` on those named with "sum",
    ``Replicate()`` on the rest."""
    return tuple(Partial() if dims.get(n) == "sum"
                 else Shard(dims[n]) if n in dims else Replicate()
                 for n in mesh.mesh_dim_names)


_GROUPS: dict = {}      # (id(mesh), names) -> (the mesh, kept alive; group)


def _group(mesh, names: tuple):
    """The process group of the ranks that differ only on the mesh dims
    ``names`` (in mesh order): one flattened mesh dim, built once a mesh
    and a set of names."""
    key = (id(mesh), names)
    if key not in _GROUPS:
        sub = mesh[names] if len(names) > 1 else mesh[names[0]]
        _GROUPS[key] = (mesh, (sub._flatten() if len(names) > 1
                               else sub).get_group())
    return _GROUPS[key][1]


def _local_weight(w, mesh, f_dim: int, decode: bool):
    """The rank's slice of an expert weight (a DTensor (E, D, F) or (E,
    F, D), F at ``f_dim``): its experts, D whole (gathered over
    ``data``), F by ``tp`` and, in decode, sub-block ``data`` index of
    that (the reference's ("tp", "data") order).  Its gradient is
    partial over ``data``."""
    pl = functools.partial(_placements, mesh)
    w = w.redistribute(mesh, pl(expert=0, tp=f_dim))
    w = w.to_local(grad_placements=pl(data="sum", expert=0, tp=f_dim))
    if decode:
        w = w.chunk(mesh["data"].size(), dim=f_dim)[
            mesh.get_local_rank("data")]
    return w


def _all_reduce(t, group):
    import torch.distributed._functional_collectives as funcol
    return funcol.wait_tensor(funcol.all_reduce(t, "sum", group))


class _Psum(torch.autograd.Function):
    """The reference's ``psum`` over ``group``: the ranks' partial
    tensors summed, the sum on every rank of the group.  The sum is
    replicated over the group and its gradient arrives replicated, so
    each rank's partial gets that gradient as it is."""

    @staticmethod
    def forward(ctx, t, group):
        return _all_reduce(t, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _PsumT(torch.autograd.Function):
    """``_Psum``'s transpose: the identity, whose gradient is summed over
    ``group``.  A tensor replicated over the group that each rank uses
    for its own part of a sum passes through it, so its gradient is the
    whole one on every rank."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


def moe_block_ep(x, p, cfg: ArchConfig, mesh, compute_dtype=torch.bfloat16,
                 decode: bool = False):
    """Expert-parallel MoE, the JAX package's ``moe_block_ep`` as
    explicit SPMD over ``mesh`` (a ``DeviceMesh`` with ``data``,
    ``expert`` and ``tp`` dims, and maybe ``pod``).

    ``x`` (B, S, D) and the leaves of ``p`` are DTensors over ``mesh``
    (any placements; a plain tensor is taken as the same global value on
    every rank).  Each rank takes the slices the reference's
    ``in_specs`` give it:

    * train / prefill: ``x`` on ``data``; ``w_gate``/``w_up`` (E, D, F)
      as ("expert", "data", "tp") and ``w_down`` (E, F, D) as
      ("expert", "tp", "data"), then gathered over ``data`` (ZeRO-3);
    * decode: ``x`` replicated; the weights as ("expert", None, ("tp",
      "data")) on F, the reference's block order (tp-major: the rank at
      (data d, tp t) holds F block t |data| + d, which DTensor's
      placements cannot say): each rank gathers its tp block over
      ``data`` and keeps sub-block d of it.  That gather holds the tp
      block whole for a moment, where XLA may reshard with an
      all-to-all.

    The router (replicated) runs on the rank's tokens.  Then, for each
    local expert in turn: its tokens are compacted by a stable argsort
    of ~hit to the capacity ``_capacity(cfg, S)``, the GLU or GELU
    products run in the compute dtype, the gates are applied and the
    result is scatter-added into a local (B_l, S, D) buffer.  One
    all-reduce sums the buffer over ("expert", "tp"), or ("expert",
    "tp", "data") in decode: the ranks that share a data index
    (``_Psum``).  Gradients: the tokens and gates enter the expert part
    through ``_PsumT``, which sums their gradient over the same ranks
    (each rank's experts give a part of it); the expert weights' is
    partial over ``data`` (reduce-scattered back to their placements by
    DTensor), the router's too outside decode.  All of it runs on local
    tensors: DTensor's sharding search for the router's product on a
    three-dim mesh costs a minute on the CPU.

    Returns (y (B, S, D) in the compute dtype on ``data`` (replicated in
    decode), router probs float32 on ``data``): DTensors when ``x`` is
    one, else the global tensors.  The probs are (B, S, E), and in
    decode (|data| B, S, E) as the reference's are: there every rank
    routes the whole batch and ``out_specs`` stacks the data ranks'
    copies (the router loss, a mean over them, is the same).
    """
    dt = functools.partial(as_dtensor, mesh=mesh)
    sharded_in = isinstance(x, DTensor)
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.n_experts_active
    C = _capacity(cfg, S)
    E_local = E // mesh["expert"].size()
    e0 = mesh.get_local_rank("expert") * E_local
    pl = functools.partial(_placements, mesh)
    x_pl = pl() if decode else pl(data=0)
    group = ("data", "expert", "tp") if decode else ("expert", "tp")

    # the rank's tokens, and the router (replicated) on them
    xl = dt(x).redistribute(mesh, x_pl).to_local().to(compute_dtype)
    wr = dt(p["router"]).redistribute(mesh, pl()).to_local(
        grad_placements=pl() if decode else pl(data="sum"))
    logits = xl.float() @ wr.to(compute_dtype).float()
    probs = torch.softmax(logits, dim=-1)
    gates, el = torch.topk(probs, k, dim=-1)                   # (B,S,k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # the expert part of each rank is partial over ``group``
    grp = _group(mesh, group)
    xe_all, gl = _PsumT.apply(xl, grp), _PsumT.apply(gates, grp)
    glu = cfg.mlp_act in ("swiglu", "geglu")
    wu, wd = (_local_weight(dt(p[n]), mesh, f, decode).to(compute_dtype)
              for n, f in (("w_up", 2), ("w_down", 1)))
    wg = (_local_weight(dt(p["w_gate"]), mesh, 2, decode).to(compute_dtype)
          if glu else None)

    Bl = xl.shape[0]
    rows = torch.arange(Bl, device=xl.device)[:, None]
    y = torch.zeros_like(xl)
    for j in range(E_local):
        gate_e = torch.where(el == e0 + j, gl, 0.0).sum(-1)    # (B_l, S)
        hit = gate_e > 0
        # compact this expert's tokens to capacity C, hits first
        order = torch.argsort((~hit).to(torch.uint8), dim=-1, stable=True)
        tok = order[:, :C]                                     # (B_l, C)
        keep = torch.gather(hit, 1, tok)
        xe = xe_all[rows, tok] * keep[..., None].to(compute_dtype)
        if glu:
            h = _act(xe @ wg[j], cfg) * (xe @ wu[j])
        else:
            h = _act(xe @ wu[j], cfg)
        ye = (h @ wd[j]) * torch.gather(gate_e, 1, tok)[..., None].to(
            compute_dtype)
        y = y.index_put((rows, tok), torch.where(keep[..., None], ye, 0.0),
                        accumulate=True)
    y = DTensor.from_local(_Psum.apply(y, grp), mesh, x_pl,
                           run_check=False, shape=(B, S, D),
                           stride=(S * D, D, 1))
    if decode:      # each data index's copy of the whole batch's probs
        probs = _PsumT.apply(probs, _group(mesh, ("data",)))
    probs = DTensor.from_local(probs, mesh, pl(data=0), run_check=False)
    if sharded_in:
        return y, probs
    return y.full_tensor(), probs.full_tensor()


def router_aux_loss(probs, eidx_onehot_mean=None):
    """Switch-style load-balance loss: E * sum(f_e * P_e), f_e the
    share of tokens whose top-1 expert is e, P_e the mean router
    probability of e."""
    del eidx_onehot_mean
    E = probs.shape[-1]
    pe = probs.mean(dim=(0, 1))
    top1 = torch.argmax(probs, dim=-1)
    fe = F.one_hot(top1, E).to(probs.dtype).mean(dim=(0, 1))
    return E * torch.sum(fe * pe)
