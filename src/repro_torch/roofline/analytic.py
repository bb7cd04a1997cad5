"""Exact analytic per-step FLOPs and first-order HBM-traffic model.

XLA's ``cost_analysis()`` counts a ``while`` (scan) body ONCE, so for a
scan-over-layers model it under-reports flops/bytes by ~n_layers x (verified
empirically — see EXPERIMENTS.md section Dry-run).  The roofline table
therefore uses this analytic model for the compute and memory terms, and
the loop-corrected HLO parse (hlo.py) for the collective term; raw HLO
numbers are recorded alongside for reference.

Conventions: matmul (m,k)x(k,n) = 2mkn FLOPs; causal self-attention scores
count 1/2; training = fwd + 2x bwd (+1x fwd recompute under full remat).
"""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig, ShapeConfig

__all__ = ["analytic_flops", "analytic_bytes", "flops_breakdown"]


def _attn_flops(cfg: ArchConfig, B: int, S: int, S_kv: int, *,
                causal: bool, window: int = 0) -> float:
    H, K, hd, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    proj = 2.0 * B * S * D * (H + 2 * K) * hd + 2.0 * B * S * H * hd * D
    eff_kv = min(S_kv, window) if window else S_kv
    sc = 2.0 * B * H * S * eff_kv * hd * 2.0          # scores + AV
    if causal and S == S_kv and not window:
        sc *= 0.5
    return proj + sc


def _mlp_flops(cfg: ArchConfig, tokens: float) -> float:
    mats = 3.0 if cfg.mlp_act in ("swiglu", "geglu") else 2.0
    return 2.0 * tokens * cfg.d_model * cfg.d_ff * mats


def _moe_flops(cfg: ArchConfig, tokens: float) -> float:
    router = 2.0 * tokens * cfg.d_model * cfg.n_experts
    mats = 3.0 if cfg.mlp_act in ("swiglu", "geglu") else 2.0
    expert = 2.0 * tokens * cfg.d_model * cfg.d_ff * mats \
        * cfg.n_experts_active * cfg.capacity_factor
    return router + expert


def _mamba_flops(cfg: ArchConfig, B: int, S: int, *, decode: bool) -> float:
    D, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    Hs, P, Kc = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_conv
    T = B * S
    proj = 2.0 * T * D * (2 * di + 2 * N + Hs) + 2.0 * T * di * D
    conv = 2.0 * T * (di + 2 * N) * Kc
    if decode:
        ssd = 2.0 * T * Hs * P * N * 2.0              # state update + C.h
    else:
        Q = min(cfg.ssm_chunk, S)
        nc = -(-S // Q)
        intra = 2.0 * B * nc * Q * Q * (N + Hs * P)   # CB + (M)X
        inter = 2.0 * B * nc * Q * Hs * P * N * 2.0   # states + C.h_prev
        ssd = intra + inter
    return proj + conv + ssd


def flops_breakdown(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Forward-pass FLOPs by component (global, one step)."""
    B, S = shape.global_batch, shape.seq_len
    decode = shape.kind == "decode"
    S_q = 1 if decode else S
    S_kv = S if decode else S
    T = B * S_q
    out: dict[str, float] = {}

    if cfg.is_encdec:
        Te = B * cfg.encoder_seq
        out["encoder"] = cfg.encoder_layers * (
            _attn_flops(cfg, B, cfg.encoder_seq, cfg.encoder_seq,
                        causal=False)
            + _mlp_flops(cfg, Te))
        out["dec_self"] = cfg.n_layers * _attn_flops(
            cfg, B, S_q, S_kv, causal=not decode)
        out["dec_cross"] = cfg.n_layers * _attn_flops(
            cfg, B, S_q, cfg.encoder_seq, causal=False)
        out["dec_mlp"] = cfg.n_layers * _mlp_flops(cfg, T)
        if decode:
            out["encoder"] = 0.0      # encoder ran at prefill
    elif cfg.family == "ssm":
        out["mamba"] = cfg.n_layers * _mamba_flops(cfg, B, S_q,
                                                   decode=decode)
    elif cfg.family == "hybrid":
        G = cfg.n_layers // (cfg.hybrid_group + 1)
        n_mamba = G * cfg.hybrid_group
        out["mamba"] = n_mamba * _mamba_flops(cfg, B, S_q, decode=decode)
        out["shared_attn"] = G * (_attn_flops(cfg, B, S_q, S_kv,
                                              causal=not decode)
                                  + _mlp_flops(cfg, T))
    else:
        n_local = cfg.n_layers // 2 if cfg.local_global_alternate else (
            cfg.n_layers if cfg.sliding_window else 0)
        n_global = cfg.n_layers - n_local
        w = cfg.sliding_window
        att = (n_global * _attn_flops(cfg, B, S_q, S_kv,
                                      causal=not decode)
               + n_local * _attn_flops(cfg, B, S_q, S_kv,
                                       causal=not decode, window=w))
        out["attention"] = att
        if cfg.is_moe:
            out["moe"] = cfg.n_layers * _moe_flops(cfg, T)
        else:
            out["mlp"] = cfg.n_layers * _mlp_flops(cfg, T)

    out["logits"] = 2.0 * T * cfg.d_model * cfg.padded_vocab
    return out


def analytic_flops(cfg: ArchConfig, shape: ShapeConfig,
                   remat_policy: str | None = "full") -> dict:
    """Per-step total FLOPs (global): forward, compiled (with train
    backward + remat multipliers), and MODEL_FLOPS (6/2 * N_active * D)."""
    fwd = sum(flops_breakdown(cfg, shape).values())
    if shape.kind == "train":
        mult = 3.0 + (1.0 if remat_policy == "full" else 0.0)
    else:
        mult = 1.0
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    model = (6.0 if shape.kind == "train" else 2.0) \
        * cfg.n_active_params() * tokens
    return {"forward": fwd, "compiled": fwd * mult, "model_flops": model,
            "tokens": tokens}


def _param_bytes(cfg: ArchConfig, shape: ShapeConfig) -> tuple[float, float]:
    """(param storage bytes, per-step param traffic bytes), global."""
    n = cfg.n_params()
    if shape.kind != "train":
        return 2.0 * n, 2.0 * n            # bf16, read once per step
    big = n > 100e9
    p_store = (2.0 if big else 4.0) * n
    # fwd read + bwd read + recompute read + grad write+read
    traffic = 3.0 * p_store + 2.0 * (2.0 if big else 4.0) * n
    # optimizer: m,v read+write (+p read/write)
    opt_elem = 4.0 if big else 16.0        # int8 m,v+scales vs fp32 m,v
    traffic += (opt_elem + 2.0 * (2.0 if big else 4.0)) * n
    return p_store, traffic


def _act_bytes_per_layer(cfg: ArchConfig, B: int, S: int) -> float:
    """Rough per-layer activation footprint (bytes, bf16 + f32 scores)."""
    D, F = cfg.d_model, cfg.d_ff
    T = B * S
    a = 4 * T * D * 2                              # residual + norms
    if cfg.n_heads:
        H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        a += T * (H + 2 * K) * hd * 2              # q,k,v
        a += B * H * S * min(S, 4096) * 4 * 0.0    # scores recomputed
        a += T * H * hd * 2
    if cfg.ssm_state:
        a += T * (2 * cfg.d_inner + 2 * cfg.ssm_state) * 2
    if cfg.is_moe:
        a += T * cfg.n_experts_active * cfg.capacity_factor * (
            2 * F + D) * 2
    elif F:
        a += T * 3 * F * 2
    return a


def analytic_bytes(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """First-order per-step HBM traffic (global bytes)."""
    B, S = shape.global_batch, shape.seq_len
    decode = shape.kind == "decode"
    S_q = 1 if decode else S
    p_store, p_traffic = _param_bytes(cfg, shape)

    layers = cfg.n_layers + cfg.encoder_layers
    act = layers * _act_bytes_per_layer(cfg, B, S_q)
    act_mult = {"train": 4.0, "prefill": 2.0, "decode": 2.0}[shape.kind]
    traffic = p_traffic + act * act_mult

    cache = 0.0
    if shape.kind != "train" and cfg.n_heads:
        n_kv_layers = (cfg.n_layers if cfg.family != "hybrid"
                       else cfg.n_layers // (cfg.hybrid_group + 1))
        cache = (2.0 * n_kv_layers * B * S
                 * cfg.n_kv_heads * cfg.head_dim * 2.0)
        if cfg.is_encdec:
            cache += 2.0 * cfg.n_layers * B * cfg.encoder_seq \
                * cfg.n_kv_heads * cfg.head_dim * 2.0
    if shape.kind != "train" and cfg.ssm_state:
        n_m = (cfg.n_layers if cfg.family == "ssm" else
               cfg.n_layers - cfg.n_layers // (cfg.hybrid_group + 1))
        cache += n_m * B * cfg.ssm_nheads * cfg.ssm_headdim \
            * cfg.ssm_state * 4.0 * 2.0            # state read+write f32
    if decode:
        traffic += cache                            # read whole cache/step
    elif shape.kind == "prefill":
        traffic += cache                            # write the cache

    # logits
    V = cfg.padded_vocab
    traffic += B * S_q * V * (6.0 if shape.kind == "train" else 4.0)

    return {"param_store": p_store, "traffic": traffic,
            "cache_bytes": cache}
