"""The attention-logit softcap and the sliding window in the port against
the JAX package, on the CPU: the flash op's plain versions (forward, lse,
backward), the model attention's prefill and decode paths, gemma2 (local
and global layers alternating, softcaps 50/30) and grok-1 (softcap 30,
MoE) at their smoke sizes.

The JAX package computes the softcap and the window in its XLA attention
(``src/repro/models/attention.py``), not in its Pallas kernel: the plain
versions here are held against its scanned form ``_chunked_attention``
and its ``attention``.  The JAX package initialises the smoke weights;
``params_from_numpy`` carries them across.  Inputs come from numpy with
a seed; q is scaled up where the cap has to bite.  Sequences are at
least 24 tokens, so the 8-token window of ``gemma2-smoke`` masks.

Tolerances, as the existing parity tests use them for the same outputs:
the attention op 2e-4 and its gradients 1e-5 (``test_torch_attention``);
float32 logits and caches 1e-4; greedy tokens exactly; the loss 1e-5
relative and every gradient leaf 1e-4 relative L2
(``test_torch_moe``); bf16 logits 5e-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke
from repro.models import attention as j_attn
from repro.models import build_model as j_build_model
from repro.models import transformer as j_tf
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.attention import ops as O
from repro_torch.kernels.attention.ref import (LOG2E, attention_bwd_ref,
                                               attention_lse_ref,
                                               attention_ref)
from repro_torch.models import attention as t_attn
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import transformer as t_tf
from repro_torch.serve import Engine, Request, ServeConfig
from repro_torch.train.optimizer import _leaves

torch.set_num_threads(1)

ARCH = "gemma2-2b"
GROK = "grok-1-314b"
S = 24
LOCALS = [True, False, None]


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _qkv(seed, S_=S, T=None, H=4, K=2, hd=16, qmul=8.0):
    """q scaled by ``qmul`` so that scores reach the softcap's bend."""
    T = S_ if T is None else T
    rng = np.random.default_rng(seed)
    return ((qmul * rng.standard_normal((2, S_, H, hd))).astype(np.float32),
            rng.standard_normal((2, T, K, hd)).astype(np.float32),
            rng.standard_normal((2, T, K, hd)).astype(np.float32))


def _window(cfg, is_local):
    return cfg.sliding_window if is_local else 0


# -- the plain versions of the flash op --------------------------------------

@pytest.mark.parametrize("is_local", LOCALS)
@pytest.mark.parametrize("causal", [True, False])
def test_attention_ref_matches_jax(is_local, causal):
    """``attention_ref`` with gemma2's softcap (50) and window (8, on a
    local layer) against the JAX package's scanned attention over kv
    blocks of 8; the cap bites (without it the output moves by > 1e-2)."""
    jcfg = j_get_smoke(ARCH)
    q, k, v = _qkv(1)
    scale = jcfg.head_dim ** -0.5
    want = j_attn._chunked_attention(
        jnp.asarray(q).reshape(2, S, 2, 2, 16), jnp.asarray(k),
        jnp.asarray(v), jcfg, is_local=is_local, causal=causal, scale=scale,
        compute_dtype=jnp.float32, block=8)
    t = [torch.as_tensor(a) for a in (q, k, v)]
    kw = dict(causal=causal, scale=scale,
              window=_window(jcfg, is_local))
    got = attention_ref(*t, softcap=jcfg.attn_logit_softcap, **kw)
    _close(got, np.asarray(want).reshape(2, S, 4, 16), 2e-4)
    assert float((attention_ref(*t, **kw) - got).abs().max()) > 1e-2
    # the op takes the same keywords and runs this plain version on the CPU
    torch.testing.assert_close(
        O.flash_attention(*t, softcap=jcfg.attn_logit_softcap, **kw), got)


@pytest.mark.parametrize("is_local", [True, False])
def test_attention_lse_ref_matches_jax(is_local):
    """The base-2 log-sum-exp of the capped, causal, windowed scores,
    from the JAX package's ``softcap`` and its masks, S != T."""
    jcfg = j_get_smoke(ARCH)
    q, k, _ = _qkv(2, S_=20, T=30)
    scale = 0.25
    s = jnp.einsum("bshd,bthd->bhst", jnp.asarray(q),
                   jnp.repeat(jnp.asarray(k), 2, axis=2)) * scale
    s = j_tf.ll.softcap(s, jcfg.attn_logit_softcap)
    t_idx, q_idx = jnp.arange(30)[None], jnp.arange(20)[:, None]
    mask = t_idx <= q_idx
    if is_local:
        mask = mask & (t_idx > q_idx - jcfg.sliding_window)
    want = jax.nn.logsumexp(jnp.where(mask, s, -jnp.inf), axis=-1) * LOG2E
    got = attention_lse_ref(torch.as_tensor(q), torch.as_tensor(k),
                            causal=True, scale=scale,
                            softcap=jcfg.attn_logit_softcap,
                            window=_window(jcfg, is_local))
    _close(got, want, 2e-4)


def _jax_grads(q, k, v, do, cfg, is_local, causal, scale):
    def f(q, k, v):
        out = j_attn._chunked_attention(
            q.reshape(2, q.shape[1], 2, 2, 16), k, v, cfg,
            is_local=is_local, causal=causal, scale=scale,
            compute_dtype=jnp.float32, block=8)
        return jnp.sum(out.reshape(do.shape) * jnp.asarray(do))
    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


@pytest.mark.parametrize("cap,is_local", [(50.0, True), (50.0, False),
                                          (None, True)])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_bwd_ref_matches_autograd_and_jax_grad(cap, is_local,
                                                         causal):
    """``attention_bwd_ref`` with the softcap's 1 - tanh^2 factor and the
    window's mask: against autograd through ``attention_ref`` in float64
    (1e-5), and, as the CPU backward of ``FlashAttentionFn``, against
    ``jax.grad`` of the JAX package's scanned attention (1e-5)."""
    jcfg = dataclasses.replace(j_get_smoke(ARCH), attn_logit_softcap=cap
                               or 0.0)
    window = _window(jcfg, is_local)
    q, k, v = _qkv(3, qmul=4.0)
    do = np.random.default_rng(4).standard_normal(q.shape).astype(
        np.float32)
    scale = 0.25
    kw = dict(causal=causal, scale=scale, softcap=cap, window=window)
    t64 = [torch.as_tensor(a, dtype=torch.float64).requires_grad_()
           for a in (q, k, v)]
    out64 = attention_ref(*t64, **kw).double()
    auto = torch.autograd.grad(out64, t64, torch.as_tensor(
        do, dtype=torch.float64))
    got = attention_bwd_ref(*(a.detach() for a in t64), out64.detach(),
                            torch.as_tensor(do, dtype=torch.float64), **kw)
    for g, a in zip(got, auto):
        np.testing.assert_allclose(g.double().numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-5)
    t = [torch.as_tensor(a).requires_grad_() for a in (q, k, v)]
    out = O.flash_attention(*t, **kw)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    fn = torch.autograd.grad(out, t, torch.as_tensor(do))
    for g, j in zip(fn, _jax_grads(q, k, v, do, jcfg, is_local, causal,
                                   scale)):
        np.testing.assert_allclose(g.numpy(), j, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_rows_without_a_key_in_the_window_match_jax(causal):
    """S >= T + window leaves rows 31-39 with no key (T 24, window 8):
    the JAX package's finite masked score gives them a uniform softmax,
    the mean of v, and ``attention_ref`` does the same (2e-4); the
    gradients, where only dv sees those rows, against autograd and
    ``jax.grad`` (1e-5)."""
    jcfg = j_get_smoke(ARCH)
    q, k, v = _qkv(5, S_=40, T=24, qmul=4.0)
    do = np.random.default_rng(6).standard_normal(q.shape).astype(
        np.float32)
    scale, window = 0.25, jcfg.sliding_window
    kw = dict(causal=causal, scale=scale, softcap=jcfg.attn_logit_softcap,
              window=window)
    want = j_attn._chunked_attention(
        jnp.asarray(q).reshape(2, 40, 2, 2, 16), jnp.asarray(k),
        jnp.asarray(v), jcfg, is_local=True, causal=causal, scale=scale,
        compute_dtype=jnp.float32, block=8)
    t = [torch.as_tensor(a) for a in (q, k, v)]
    got = attention_ref(*t, **kw)
    _close(got, np.asarray(want).reshape(2, 40, 4, 16), 2e-4)
    mean_v = t[2].mean(dim=1).repeat_interleave(2, dim=1)     # (2, H, hd)
    _close(got[:, 24 + window - 1:], mean_v[:, None].expand(2, 9, 4, 16))
    t64 = [torch.as_tensor(a, dtype=torch.float64).requires_grad_()
           for a in (q, k, v)]
    out64 = attention_ref(*t64, **kw).double()
    auto = torch.autograd.grad(out64, t64, torch.as_tensor(
        do, dtype=torch.float64))
    got = attention_bwd_ref(*(a.detach() for a in t64), out64.detach(),
                            torch.as_tensor(do, dtype=torch.float64), **kw)
    for g, a, j in zip(got, auto, _jax_grads(q, k, v, do, jcfg, True,
                                             causal, scale)):
        np.testing.assert_allclose(g.double().numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(g.numpy(), j, rtol=1e-5, atol=1e-5)


# -- the model attention: prefill and decode ----------------------------------

_MODELS = {}


def _models(arch, dtype):
    """(cfg, JAX model, JAX params, port model, port params) on one set
    of weights; float32 master weights for the float32 port."""
    if (arch, dtype) not in _MODELS:
        cfg, jcfg = get_smoke_config(arch), j_get_smoke(arch)
        jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        jm = j_build_model(jcfg, compute_dtype=jdt)
        jp = jm.init_params(jax.random.PRNGKey(0))
        tree = jax.tree_util.tree_map(np.asarray, jp)
        tm = build_model(cfg, dtype)
        tp = params_from_numpy(cfg, tree, device="cpu", compute_dtype=dtype,
                               param_dtype=torch.float32
                               if dtype == torch.float32 else None)
        _MODELS[(arch, dtype)] = (cfg, jm, jp, tm, tp)
    return _MODELS[(arch, dtype)]


def _layer0_attn(jp, tp):
    return (jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["attn"]),
            {k: v[0] for k, v in tp["blocks"]["attn"].items()})


@pytest.mark.parametrize("is_local", LOCALS)
@pytest.mark.parametrize("causal", [True, False])
def test_model_attention_prefill_matches_jax(is_local, causal):
    """``models.attention.attention`` in prefill (the flash op) against
    the JAX package's, the fresh k/v returned as the cache."""
    cfg, jm, jp, tm, tp = _models(ARCH, torch.float32)
    j_p, t_p = _layer0_attn(jp, tp)
    rng = np.random.default_rng(5)
    x = (3.0 * rng.standard_normal((2, S, cfg.d_model))).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (2, 1))
    want, (wk, wv) = j_attn.attention(
        j_p, jnp.asarray(x), jnp.asarray(pos), j_get_smoke(ARCH),
        is_local=is_local, causal=causal, compute_dtype=jnp.float32,
        return_kv=True)
    got, (gk, gv) = t_attn.attention(
        t_p, torch.as_tensor(x), torch.as_tensor(pos), cfg,
        is_local=is_local, causal=causal, compute_dtype=torch.float32,
        return_kv=True)
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)


@pytest.mark.parametrize("is_local", LOCALS)
@pytest.mark.parametrize("S_new", [1, 3])
def test_model_attention_decode_past_the_window_matches_jax(is_local,
                                                            S_new):
    """Decode over a 40-slot cache at per-row offsets 20 and 31, past the
    8-token window: the cache written in place, the capped scores
    masked by ``t <= q_abs`` and, on a local layer, ``t > q_abs -
    window``, as the JAX package's decode masks them."""
    cfg, jm, jp, tm, tp = _models(ARCH, torch.float32)
    j_p, t_p = _layer0_attn(jp, tp)
    rng = np.random.default_rng(6 + S_new)
    x = (3.0 * rng.standard_normal((2, S_new, cfg.d_model))).astype(
        np.float32)
    ck, cv = rng.standard_normal(
        (2, 2, 40, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
    off = np.array([20, 31], np.int32)
    pos = off[:, None] + np.arange(S_new, dtype=np.int32)[None]
    want, (wk, wv) = j_attn.attention(
        j_p, jnp.asarray(x), jnp.asarray(pos), j_get_smoke(ARCH),
        is_local=is_local, cache_k=jnp.asarray(ck), cache_v=jnp.asarray(cv),
        pos_offset=jnp.asarray(off), compute_dtype=jnp.float32)
    tk, tv = torch.as_tensor(ck.copy()), torch.as_tensor(cv.copy())
    got, (gk, gv) = t_attn.attention(
        t_p, torch.as_tensor(x), torch.as_tensor(pos), cfg,
        is_local=is_local, cache_k=tk, cache_v=tv,
        pos_offset=torch.as_tensor(off), compute_dtype=torch.float32)
    assert gk is tk and gv is tv
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)


def test_static_cache_takes_the_window_and_the_cap():
    """A static cache (``cache_k`` without ``pos_offset``) on a local
    layer: the JAX package masks it causally from position 0 and by the
    window, after the cap."""
    cfg, jm, jp, tm, tp = _models(ARCH, torch.float32)
    j_p, t_p = _layer0_attn(jp, tp)
    rng = np.random.default_rng(9)
    x = (3.0 * rng.standard_normal((2, S, cfg.d_model))).astype(np.float32)
    ck, cv = rng.standard_normal(
        (2, 2, S, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (2, 1))
    want, _ = j_attn.attention(
        j_p, jnp.asarray(x), jnp.asarray(pos), j_get_smoke(ARCH),
        is_local=True, cache_k=jnp.asarray(ck), cache_v=jnp.asarray(cv),
        compute_dtype=jnp.float32)
    got, _ = t_attn.attention(
        t_p, torch.as_tensor(x), torch.as_tensor(pos), cfg, is_local=True,
        cache_k=torch.as_tensor(ck), cache_v=torch.as_tensor(cv),
        compute_dtype=torch.float32)
    _close(got, want)


# -- gemma2 and grok-1 ---------------------------------------------------------

def _tokens(cfg, B, L, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, L)).astype(np.int32)


@pytest.mark.parametrize("arch", [ARCH, GROK])
@pytest.mark.parametrize("kind", ["smoke", "full"])
def test_param_shapes_and_axes_match_jax(arch, kind):
    cfg = (get_smoke_config if kind == "smoke" else get_config)(arch)
    jm = j_build_model((j_get_smoke if kind == "smoke"
                        else j_get_config)(arch))
    tm = build_model(cfg)
    assert tm.param_shapes() == jax.tree_util.tree_map(
        lambda s: tuple(s.shape), jm.abstract_params())
    assert tm._defs(lambda path, shape, ax, fan_in=None, kind="normal":
                    tuple(ax)) == jm.param_axes()
    spec, axes = tm.cache_spec(2, 64)
    jspec, jaxes = jm.cache_spec(2, 64)
    assert axes == jaxes
    assert {n: s[0] for n, s in spec.items()} == {
        n: tuple(s.shape) for n, s in jspec.items()}


def test_local_layers_alternate_from_layer_0(monkeypatch):
    """gemma2's layers take the window in turns from layer 0 (the JAX
    package's ``arange(L) % 2 == 0``); a config with a window alone
    makes every layer local, one without none."""
    cfg, jm, jp, tm, tp = _models(ARCH, torch.float32)
    seen = []
    orig = t_tf.attention

    def spy(*a, is_local=None, **k):
        seen.append(is_local)
        return orig(*a, is_local=is_local, **k)
    monkeypatch.setattr(t_tf, "attention", spy)
    tm.prefill(tp, {"tokens": torch.as_tensor(_tokens(cfg, 1, 9, 1))})
    assert seen == [True, False]
    assert [t_tf._is_local(dataclasses.replace(
        cfg, local_global_alternate=False), i) for i in range(3)] == [True] * 3
    assert not t_tf._is_local(get_smoke_config(GROK), 0)


@pytest.mark.parametrize("arch", [ARCH, GROK])
def test_lm_forward_train_matches_jax(arch):
    cfg, jm, jp, tm, tp = _models(arch, torch.float32)
    toks = _tokens(cfg, 2, S, seed=10)
    want, _, _ = j_tf.lm_forward(jp, j_get_smoke(arch),
                                 tokens=jnp.asarray(toks), mode="train",
                                 compute_dtype=jnp.float32)
    got, _, _ = t_tf.lm_forward(tp, cfg, tokens=torch.as_tensor(toks),
                                mode="train", compute_dtype=torch.float32)
    assert got.shape == (2, S, cfg.padded_vocab)
    _close(got, want)


@pytest.mark.parametrize("arch,L", [(ARCH, S), (ARCH, 29), (GROK, S)])
def test_prefill_matches_jax_f32(arch, L):
    """The last logits and the cache; gemma2 at 24 and 29 tokens, where
    the 8-token window masks on its local layer: without the window the
    logits move."""
    cfg, jm, jp, tm, tp = _models(arch, torch.float32)
    toks = _tokens(cfg, 2, L, seed=L)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.as_tensor(toks)})
    _close(tl, jl)
    assert list(tc) == list(jc)
    for n in tc:
        _close(tc[n], jc[n])
    if arch == ARCH:
        wide = build_model(dataclasses.replace(cfg, sliding_window=0),
                           torch.float32)
        lw, _ = wide.prefill(tp, {"tokens": torch.as_tensor(toks)})
        assert float((lw - tl).abs().max()) > 1e-3


def test_greedy_decode_past_the_window_matches_jax_f32():
    """Prefill 24 tokens, pad the cache to 40, 8 greedy decode steps
    (every step's window masks on the local layer): the same tokens and
    caches."""
    cfg, jm, jp, tm, tp = _models(ARCH, torch.float32)
    toks = _tokens(cfg, 2, S, seed=11)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.as_tensor(toks)})
    jc = {n: jnp.pad(a, [(0, 0), (0, 0), (0, 40 - S), (0, 0), (0, 0)])
          for n, a in jc.items()}
    cache = tm.init_cache(2, 40, device="cpu")
    for n in cache:
        cache[n][:, :, :S] = tc[n]
    jt = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)
    tt = torch.argmax(tl[:, -1], -1).to(torch.int32)
    jpos, tpos = jnp.full((2,), S, jnp.int32), torch.full((2,), S)
    for _ in range(8):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jt, jc = jm.decode_step(jp, jc, jt, jpos)
        tt, cache = tm.decode_step(tp, cache, tt, tpos)
        jpos, tpos = jpos + 1, tpos + 1
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    for n in cache:
        _close(cache[n], jc[n])


@pytest.mark.parametrize("arch,remat", [(ARCH, None), (ARCH, "full"),
                                        (ARCH, "dots"), (GROK, None)])
def test_lm_loss_and_grads_match_jax(arch, remat):
    """``lm_loss`` and every leaf's gradient against
    ``jax.value_and_grad``: the attention differentiates through
    ``FlashAttentionFn``, whose CPU backward is ``attention_bwd_ref``
    with the softcap and the window."""
    cfg, jm, jp, tm, tp = _models(arch, torch.float32)
    toks = _tokens(cfg, 2, S + 1, seed=12)
    b = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    (j_loss, _), j_grads = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    leaves = _leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, _ = tm.loss(tp, {k: torch.as_tensor(v) for k, v in b.items()},
                          remat_policy=remat)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    assert float(loss.detach()) == pytest.approx(float(j_loss), rel=1e-5)
    j_leaves = jax.tree_util.tree_leaves(j_grads)
    assert len(grads) == len(j_leaves)
    for g, jg in zip(grads, j_leaves):
        assert g.shape == jg.shape
        assert _rel_l2(g.numpy(), jg) <= 1e-4


@pytest.mark.parametrize("arch", [ARCH, GROK])
def test_prefill_matches_jax_bf16(arch):
    cfg, jm, jp, tm, tp = _models(arch, torch.bfloat16)
    toks = _tokens(cfg, 2, S, seed=13)
    jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.as_tensor(toks)})
    assert tc["k"].dtype == torch.bfloat16
    _close(tl, jl, 5e-2)


def test_engine_round_equals_the_direct_decode():
    """``serve.Engine`` on gemma2, prompts of 27 tokens and 6 new ones
    (past the window): each request's tokens equal the JAX package's
    direct greedy decode of the round."""
    cfg, jm, jp, tm, tp = _models(ARCH, torch.float32)
    B, max_seq, L = 2, 48, S + 3
    eng = Engine(tm, tp, ServeConfig(batch_size=B, max_seq=max_seq,
                                     queue_capacity=8), device="cpu")
    rows = _tokens(cfg, B, L, seed=14)
    reqs = [Request(rid=i, tokens=rows[i], max_new=6) for i in range(B)]
    eng.start()
    try:
        for r in reqs:
            assert eng.submit(r, timeout=30.0)
        for r in reqs:
            assert r.done.wait(timeout=120)
        assert not eng._crashes
    finally:
        eng.stop()
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(rows)})
    jc = {n: jnp.pad(a, [(0, 0), (0, 0), (0, max_seq - L), (0, 0), (0, 0)])
          for n, a in jc.items()}
    cur = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)
    pos = jnp.full((B,), L, jnp.int32)
    want = []
    for _ in range(6):
        want.append(np.asarray(cur))
        cur, jc = jm.decode_step(jp, jc, cur, pos)
        pos = pos + 1
    want = np.stack(want, 1)
    for i, r in enumerate(reqs):
        np.testing.assert_array_equal(r.out, want[i])
