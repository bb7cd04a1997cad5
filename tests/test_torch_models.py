"""The port's dense model stack against the JAX package, on the CPU.

The JAX package initialises the weights; ``params_from_numpy`` carries
them into the port in the same layout.  Token ids come from numpy with
a seed.  The prefill's attention runs the flash-attention op's plain
version here (CPU tensors); the JAX model runs its own plain softmax.

Tolerances: float32 layers to 1e-6 (same operations, XLA's and
PyTorch's rounding); float32 prefill logits and cache to 1e-4 (summation
orders over d = 2048 and the vocabulary); greedy tokens exactly; bf16
logits to 5e-2 (bf16 rounds at different places in the two frameworks).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke
from repro.models import build_model as j_build_model
from repro.models import layers as j_ll
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import layers as t_ll
from repro_torch.models.attention import _update_cache

torch.set_num_threads(1)

ARCH = "internlm2-1.8b"


def _cfgs(kind):
    """(port config, JAX config): the smoke config, or internlm2's real
    per-layer widths (d 2048, 16/8 heads, hd 128, d_ff 8192) cut to one
    layer and a 512-token vocabulary."""
    if kind == "smoke":
        return get_smoke_config(ARCH), j_get_smoke(ARCH)
    cut = dict(name="internlm2-1layer", n_layers=1, vocab_size=512)
    return (dataclasses.replace(get_config(ARCH), **cut),
            dataclasses.replace(j_get_config(ARCH), **cut))


_MODELS = {}


def _models(kind, dtype):
    """JAX model + params and the port's, sharing one set of weights."""
    key = (kind, dtype)
    if key not in _MODELS:
        cfg, jcfg = _cfgs(kind)
        jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        jm = j_build_model(jcfg, compute_dtype=jdt)
        jp = jm.init_params(jax.random.PRNGKey(0))
        tree = jax.tree_util.tree_map(np.asarray, jp)
        tm = build_model(cfg, dtype)
        tp = params_from_numpy(cfg, tree, device="cpu", compute_dtype=dtype)
        _MODELS[key] = (cfg, jm, jp, tm, tp)
    return _MODELS[key]


def _tokens(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


# -- layers -------------------------------------------------------------------

def test_rmsnorm_and_layernorm_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32) * 0.1
    b = rng.standard_normal(64).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        t_ll.rmsnorm(torch.as_tensor(x), torch.as_tensor(w)).numpy(),
        np.asarray(j_ll.rmsnorm(jnp.asarray(x), jnp.asarray(w))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        t_ll.layernorm(*map(torch.as_tensor, (x, w, b))).numpy(),
        np.asarray(j_ll.layernorm(*map(jnp.asarray, (x, w, b)))),
        rtol=1e-6, atol=1e-6)
    xb = torch.as_tensor(x).bfloat16()
    assert t_ll.rmsnorm(xb, torch.as_tensor(w)).dtype == torch.bfloat16


@pytest.mark.parametrize("hd,theta", [(16, 10_000.0), (128, 1_000_000.0)])
def test_rope_matches_jax(hd, theta):
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 24, 3, hd)).astype(np.float32)
    pos = np.stack([np.arange(24), np.arange(24) + 5]).astype(np.int32)
    np.testing.assert_allclose(
        t_ll.rope_apply(torch.as_tensor(x), torch.as_tensor(pos),
                        theta).numpy(),
        np.asarray(j_ll.rope_apply(jnp.asarray(x), jnp.asarray(pos), theta)),
        rtol=1e-6, atol=1e-6)
    pos3 = np.stack([pos, pos + 1, pos + 2])
    np.testing.assert_allclose(
        t_ll.mrope_apply(torch.as_tensor(x), torch.as_tensor(pos3),
                         theta).numpy(),
        np.asarray(j_ll.mrope_apply(jnp.asarray(x), jnp.asarray(pos3),
                                    theta)),
        rtol=1e-6, atol=1e-6)


# -- the model ----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["smoke", "wide"])
def test_prefill_matches_jax_f32(kind):
    cfg, jm, jp, tm, tp = _models(kind, torch.float32)
    toks = _tokens(cfg, 2, 12)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.as_tensor(toks)})
    assert tl.shape == (2, 1, cfg.padded_vocab) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    for n in ("k", "v"):
        assert tc[n].shape == (cfg.n_layers, 2, 12, cfg.n_kv_heads,
                               cfg.head_dim)
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                   rtol=1e-4, atol=1e-4)


def test_one_token_prompt_matches_jax_f32():
    """S = 1: the JAX package takes its plain softmax, the port the flash
    op; the same function."""
    cfg, jm, jp, tm, tp = _models("smoke", torch.float32)
    toks = _tokens(cfg, 3, 1, seed=3)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["smoke", "wide"])
def test_greedy_decode_matches_jax_f32(kind):
    """Prefill, pad the cache to 32, then 4 greedy decode steps: the
    same tokens in both packages."""
    cfg, jm, jp, tm, tp = _models(kind, torch.float32)
    toks = _tokens(cfg, 2, 9, seed=1)
    S = 32
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.as_tensor(toks)})
    jc = {n: jnp.pad(a, [(0, 0), (0, 0), (0, S - 9), (0, 0), (0, 0)])
          for n, a in jc.items()}
    tcache = tm.init_cache(2, S, device="cpu")
    for n in tcache:
        tcache[n][:, :, :9] = tc[n]
    jt = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)
    tt = torch.argmax(tl[:, -1], -1).to(torch.int32)
    jpos, tpos = jnp.asarray([9, 9], jnp.int32), torch.tensor([9, 9])
    for _ in range(4):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jt, jc = jm.decode_step(jp, jc, jt, jpos)
        tt, tcache = tm.decode_step(tp, tcache, tt, tpos)
        jpos, tpos = jpos + 1, tpos + 1
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jc["k"]),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["smoke", "wide"])
def test_prefill_matches_jax_bf16(kind):
    cfg, jm, jp, tm, tp = _models(kind, torch.bfloat16)
    assert tp["blocks"]["attn"]["wq"].dtype == torch.bfloat16
    assert tp["blocks"]["ln1"]["w"].dtype == torch.float32
    toks = _tokens(cfg, 2, 16, seed=2)
    jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.as_tensor(toks)})
    assert tc["k"].dtype == torch.bfloat16
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=5e-2,
                               atol=5e-2)


def test_decode_write_past_the_end_clamps_like_jax():
    """A decode write at pos >= S_max lands at S_max - 1, as
    ``jax.lax.dynamic_update_slice`` clamps it; attention then sees the
    whole cache."""
    cfg, jm, jp, tm, tp = _models("smoke", torch.float32)
    S = 12
    toks = _tokens(cfg, 2, S, seed=4)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    _, tc = tm.prefill(tp, {"tokens": torch.as_tensor(toks)})
    cur = np.array([5, 7], np.int32)
    pos = np.array([S + 3, S - 1], np.int32)
    jt, jc = jm.decode_step(jp, jc, jnp.asarray(cur), jnp.asarray(pos))
    tt, tc = tm.decode_step(tp, tc, torch.as_tensor(cur),
                            torch.as_tensor(pos))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                   rtol=1e-4, atol=1e-4)


def test_update_cache_clamps_both_ends():
    ck = torch.zeros(3, 6, 1, 2)
    cv = torch.zeros(3, 6, 1, 2)
    new = torch.arange(3 * 2 * 2, dtype=torch.float32).reshape(3, 2, 1, 2) + 1
    _update_cache(ck, cv, new, new, torch.tensor([-2, 2, 9]))
    np.testing.assert_array_equal(ck[0, :2].numpy(), new[0].numpy())
    np.testing.assert_array_equal(ck[1, 2:4].numpy(), new[1].numpy())
    np.testing.assert_array_equal(ck[2, 4:].numpy(), new[2].numpy())
    assert float(ck[2, :4].abs().sum()) == 0.0


def test_params_carry_across_unchanged():
    cfg, jm, jp, tm, tp = _models("smoke", torch.float32)
    np.testing.assert_array_equal(tp["blocks"]["attn"]["wq"].numpy(),
                                  np.asarray(jp["blocks"]["attn"]["wq"]))
    bad = jax.tree_util.tree_map(np.asarray, jp)
    bad["embed"] = bad["embed"][:, :8]
    with pytest.raises(ValueError):
        params_from_numpy(cfg, bad, device="cpu")


def test_init_params_shapes_and_dtypes():
    cfg = get_smoke_config(ARCH)
    m = build_model(cfg, torch.bfloat16)
    p = m.init_params(torch.Generator().manual_seed(0), torch.bfloat16,
                      device="cpu")
    assert tuple(p["blocks"]["mlp"]["w_gate"].shape) == (
        cfg.n_layers, cfg.d_model, cfg.d_ff)
    assert p["embed"].dtype == torch.bfloat16
    assert p["final_norm"]["w"].dtype == torch.float32
    assert float(p["final_norm"]["w"].abs().sum()) == 0.0
    w = p["blocks"]["attn"]["wq"].float()
    bound = 3.0 / cfg.d_model ** 0.5
    assert float(w.abs().max()) <= bound * 1.01
    q = m.init_params(torch.Generator().manual_seed(0), torch.bfloat16,
                      device="cpu")
    torch.testing.assert_close(q["embed"], p["embed"])


def test_init_params_takes_the_reference_dtype_argument():
    """``init_params(key, param_dtype=float32)`` as in the reference: a
    positional dtype is the parameters' dtype, and with none the matrices
    are float32 master weights whatever the compute dtype; the same
    generator seed gives the same draws in either dtype."""
    m = build_model(get_smoke_config(ARCH), torch.bfloat16)
    f = m.init_params(torch.Generator().manual_seed(0), device="cpu")
    b = m.init_params(torch.Generator().manual_seed(0), torch.bfloat16,
                      device="cpu")
    assert f["embed"].dtype == torch.float32
    assert f["blocks"]["attn"]["wq"].dtype == torch.float32
    assert b["embed"].dtype == torch.bfloat16
    assert b["final_norm"]["w"].dtype == torch.float32
    assert torch.equal(b["embed"], f["embed"].to(torch.bfloat16))



def test_init_creator_takes_the_reference_dtype_argument():
    """``init_creator(key, param_dtype=float32)`` as in the reference: a
    positional dtype is the leaves' dtype, and ``device`` is a trailing
    keyword (the card unless the caller asks for the CPU)."""
    from repro_torch.models.layers import init_creator
    mk = init_creator(torch.Generator().manual_seed(0), torch.bfloat16,
                      device="cpu")
    w = mk("w", (4, 8), ("embed", "mlp"), fan_in=4)
    one = mk("g", (8,), ("embed",), kind="ones")
    assert w.dtype == one.dtype == torch.bfloat16
    assert w.device.type == one.device.type == "cpu"
    f = init_creator(torch.Generator().manual_seed(0), device="cpu")(
        "w", (4, 8), ("embed", "mlp"), fan_in=4)
    assert f.dtype == torch.float32
    assert torch.equal(w, f.to(torch.bfloat16))

# -- the reference's attention keywords ---------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("threshold", [16_384, 4])
def test_attention_keywords_match_jax(causal, threshold):
    """``attention`` takes the reference's keywords: ``causal`` passes
    through to the flash op, and ``chunked_threshold`` (where the JAX
    package switches to its scanned online softmax) and ``is_local``
    (on a config without a window) change nothing."""
    from repro.models.attention import attention as j_attention
    from repro_torch.models.attention import attention as t_attention
    cfg, jm, jp, tm, tp = _models("smoke", torch.float32)
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (2, 24, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(24, dtype=np.int32), (2, 1))
    j_p = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["attn"])
    t_p = {k: v[0] for k, v in tp["blocks"]["attn"].items()}
    want, _ = j_attention(j_p, jnp.asarray(x), jnp.asarray(pos), cfg,
                          is_local=True, causal=causal,
                          compute_dtype=jnp.float32,
                          chunked_threshold=threshold)
    got, _ = t_attention(t_p, torch.as_tensor(x), torch.as_tensor(pos), cfg,
                         is_local=True, causal=causal,
                         compute_dtype=torch.float32,
                         chunked_threshold=threshold)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _cross_attention_pair(form):
    """The JAX package's ``attention`` and the port's on one input in a
    cross-attention form, float32: (out, (k, v)) of each, and the port's
    cache arguments."""
    from repro.models.attention import attention as j_attention
    from repro_torch.models.attention import attention
    cfg, jm, jp, _, tp = _models("smoke", torch.float32)
    rng = np.random.default_rng(8)
    x = rng.normal(0, 1, (2, 5, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(5, dtype=np.int32), (2, 1))
    j_p = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["attn"])
    t_p = {k: v[0] for k, v in tp["blocks"]["attn"].items()}
    if form == "kv_x":
        enc = rng.normal(0, 1, (2, 19, cfg.d_model)).astype(np.float32)
        kw_j, kw_t = ({"kv_x": jnp.asarray(enc), "return_kv": True},
                      {"kv_x": torch.as_tensor(enc), "return_kv": True})
    else:
        kv = rng.normal(0, 1, (2, 2, 19, cfg.n_kv_heads,
                               cfg.head_dim)).astype(np.float32)
        kw_j = {"cache_k": jnp.asarray(kv[0]), "cache_v": jnp.asarray(kv[1])}
        kw_t = {"cache_k": torch.as_tensor(kv[0]),
                "cache_v": torch.as_tensor(kv[1])}
    want = j_attention(j_p, jnp.asarray(x), jnp.asarray(pos), cfg,
                       causal=False, compute_dtype=jnp.float32, **kw_j)
    got = attention(t_p, torch.as_tensor(x), torch.as_tensor(pos), cfg,
                    causal=False, compute_dtype=torch.float32, **kw_t)
    return cfg, want, got, kw_t


def test_attention_refuses_cross_attention():
    """Cross-attention is not refused: k/v from ``kv_x`` (no RoPE on k,
    no causal mask, S != T) and a static cache (``cache_k`` without
    ``pos_offset``: the keys and values as they are, returned unchanged)
    match the JAX package's ``attention`` at float32.  ``init_cache_spec``
    gives the reference's shapes and dtypes."""
    from repro_torch.models.attention import init_cache_spec
    for form in ("kv_x", "static_cache"):
        cfg, (want, (wk, wv)), (got, (gk, gv)), kw_t = \
            _cross_attention_pair(form)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
        for g, w in ((gk, wk), (gv, wv)):
            assert g.shape == (2, 19, cfg.n_kv_heads, cfg.head_dim)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                       atol=1e-4)
        if form == "static_cache":
            assert gk is kw_t["cache_k"] and gv is kw_t["cache_v"]
    spec = init_cache_spec(cfg, 2, 16, torch.float32, layers=3)
    assert spec.k == ((3, 2, 16, cfg.n_kv_heads, cfg.head_dim),
                      torch.float32)
    assert init_cache_spec(cfg, 2, 16).v[1] == torch.bfloat16


@pytest.mark.parametrize("arch", ["whisper-large-v3",
                                  "phi3.5-moe-42b-a6.6b", "zamba2-7b",
                                  "gemma2-2b", "grok-1-314b"])
@pytest.mark.parametrize("kind", ["smoke", "full"])
def test_ported_families_build(arch, kind):
    """The enc-dec, MoE, hybrid and softcapped or windowed configs build,
    full and smoke; their parameter trees carry the reference's
    leaves."""
    cfg = (get_smoke_config if kind == "smoke" else get_config)(arch)
    shapes = build_model(cfg).param_shapes()
    assert ("dec_blocks" in shapes) == cfg.is_encdec
    assert ("moe" in shapes.get("blocks", {})) == cfg.is_moe
