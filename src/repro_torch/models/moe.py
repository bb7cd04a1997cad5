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

The JAX package's expert-parallel form (``moe_block_ep``, a
``shard_map`` over an expert mesh axis) is not ported: the port runs on
one card (ROADMAP.md, Queue 1 item 6).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig

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


def _experts(buf, p, cfg: ArchConfig, compute_dtype):
    """buf (E, N, D) -> (E, N, D): each expert's MLP on its N slots, in
    the compute dtype."""
    def mm(a, w):
        return torch.bmm(a, w.to(compute_dtype))
    if cfg.mlp_act in ("swiglu", "geglu"):
        g = mm(buf, p["w_gate"])
        u = mm(buf, p["w_up"])
        g = (F.silu(g) if cfg.mlp_act == "swiglu"
             else F.gelu(g, approximate="tanh"))
        h = g * u
    else:
        h = F.gelu(mm(buf, p["w_up"]), approximate="tanh")
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
    buf = buf[:, :-1].reshape(B, E, C, D).transpose(0, 1)     # (E,B,C,D)
    y_e = _experts(buf.reshape(E, B * C, D), p, cfg, compute_dtype)
    y_e = y_e.reshape(E, B, C, D).transpose(0, 1).reshape(B, E * C, D)

    # combine: read each kept slot back, weight by its gate, scatter-add
    y_flat = torch.cat([y_e, y_e.new_zeros((B, 1, D))], dim=1)
    y_slots = y_flat[rows, slot]
    gate_sorted = torch.gather(gates.reshape(B, S * k), 1, order)
    y_slots = y_slots * gate_sorted[..., None].to(compute_dtype)
    y = x.new_zeros((B, S, D)).index_put((rows, tok), y_slots,
                                         accumulate=True)
    return y, probs


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
