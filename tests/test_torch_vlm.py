"""The vlm family (qwen2-vl) in the port against the JAX package, on the
CPU: M-RoPE at the attention op with distinct (t, h, w) position
streams, prefill from precomputed patch embeddings, decode of text
tokens after it, ``lm_loss`` on embeddings and ``serve.Engine`` on text
prompts, all at ``qwen2-vl-smoke`` (2 layers, d 96, 4/2 heads x 24).

The JAX package initialises the weights; ``params_from_numpy`` carries
them across.  Embeddings, tokens and targets come from numpy with a
seed.  The port's prefill attention runs the flash op's plain version
(CPU tensors), the JAX package its own plain softmax.

Tolerances: float32 outputs, logits and caches to 1e-5 (rtol and atol:
the same operations in XLA's and PyTorch's rounding at d 96); greedy
tokens exactly; the loss to 1e-5 relative.
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
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import attention as t_attn
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import transformer as t_tf
from repro_torch.serve import Engine, Request, ServeConfig

torch.set_num_threads(1)

ARCH = "qwen2-vl-72b"
GRID = (4, 6)              # the patch grid of the vision positions
TEXT = 8                   # text tokens after the patches
TOL = 1e-5

_MODELS = {}


def _models():
    """(port cfg, JAX cfg, JAX model, JAX params, port model, port
    params), float32, one set of weights."""
    if not _MODELS:
        cfg, jcfg = get_smoke_config(ARCH), j_get_smoke(ARCH)
        jm = j_build_model(jcfg, compute_dtype=jnp.float32)
        jp = jm.init_params(jax.random.PRNGKey(0))
        tm = build_model(cfg, torch.float32)
        tp = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu", compute_dtype=torch.float32)
        _MODELS["f32"] = (cfg, jcfg, jm, jp, tm, tp)
    return _MODELS["f32"]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def vision_positions(B, grid=GRID, text=TEXT):
    """Qwen2-VL's (3, B, S) streams for one image then text: the patches
    at t = 0, h their row, w their column; the text after them at t = h
    = w = max + 1, counting up."""
    gh, gw = grid
    t = np.zeros(gh * gw, np.int32)
    h = np.repeat(np.arange(gh, dtype=np.int32), gw)
    w = np.tile(np.arange(gw, dtype=np.int32), gh)
    start = max(gh, gw)
    txt = np.arange(start, start + text, dtype=np.int32)
    pos = np.stack([np.concatenate([s, txt]) for s in (t, h, w)])
    return np.ascontiguousarray(np.broadcast_to(pos[:, None],
                                                (3, B, pos.shape[1])))


def _embeds(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _layer0_attn(jp, tp):
    return (jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["attn"]),
            {k: v[0] for k, v in tp["blocks"]["attn"].items()})


def test_full_config_builds_with_the_reference_shapes():
    cfg = get_config(ARCH)
    tm = build_model(cfg)
    jm = j_build_model(j_get_config(ARCH))
    assert tm.param_shapes() == jax.tree_util.tree_map(
        lambda s: tuple(s.shape), jm.abstract_params())
    assert cfg.rope_mode == "mrope" and cfg.input_kind == "embeds"


def test_positions_are_the_text_streams_broadcast():
    cfg = get_smoke_config(ARCH)
    pos = t_tf._positions_for(cfg, 2, 5, torch.tensor([0, 7]), "cpu")
    assert pos.shape == (3, 2, 5)
    want = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]])
    for s in range(3):
        np.testing.assert_array_equal(pos[s].numpy(), want)
    dense = dataclasses.replace(cfg, rope_mode="rope")
    assert t_tf._positions_for(dense, 2, 5, None, "cpu").shape == (2, 5)


@pytest.mark.parametrize("swap", [False, True])
def test_attention_with_vision_streams_matches_jax(swap):
    """One layer's attention in prefill over a 4 x 6 patch grid and 8
    text tokens, its (t, h, w) streams distinct: output and fresh k/v
    within 1e-5 of the JAX package's.  With the h and w streams swapped
    (on both sides) the output moves, so the streams reach the
    rotation."""
    cfg, jcfg, jm, jp, tm, tp = _models()
    j_p, t_p = _layer0_attn(jp, tp)
    B = 2
    pos = vision_positions(B)
    if swap:
        pos = pos[[0, 2, 1]]
    S = pos.shape[-1]
    x = (2.0 * _embeds(cfg, B, S, seed=1))
    want, (wk, wv) = j_attn.attention(
        j_p, jnp.asarray(x), jnp.asarray(pos), jcfg,
        compute_dtype=jnp.float32, return_kv=True)
    got, (gk, gv) = t_attn.attention(
        t_p, torch.as_tensor(x), torch.as_tensor(pos), cfg,
        compute_dtype=torch.float32, return_kv=True)
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)
    if swap:
        straight, _ = t_attn.attention(
            t_p, torch.as_tensor(x), torch.as_tensor(vision_positions(B)),
            cfg, compute_dtype=torch.float32)
        assert float((straight - got).abs().max()) > 1e-3


def test_attention_decode_with_vision_streams_matches_jax():
    """Decode of 3 tokens over a 40-slot cache at per-row offsets, the
    queries at distinct (t, h, w) positions: the cache is written at the
    (B,) offset, the output within 1e-5 of the JAX package's."""
    cfg, jcfg, jm, jp, tm, tp = _models()
    j_p, t_p = _layer0_attn(jp, tp)
    rng = np.random.default_rng(3)
    x = _embeds(cfg, 2, 3, seed=4)
    ck, cv = rng.standard_normal(
        (2, 2, 40, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
    off = np.array([20, 31], np.int32)
    pos = vision_positions(2, grid=(2, 3), text=0)[:, :, 2:5] + off[:, None]
    want, (wk, wv) = j_attn.attention(
        j_p, jnp.asarray(x), jnp.asarray(pos), jcfg,
        cache_k=jnp.asarray(ck), cache_v=jnp.asarray(cv),
        pos_offset=jnp.asarray(off), compute_dtype=jnp.float32)
    tk, tv = torch.as_tensor(ck.copy()), torch.as_tensor(cv.copy())
    got, (gk, gv) = t_attn.attention(
        t_p, torch.as_tensor(x), torch.as_tensor(np.ascontiguousarray(pos)),
        cfg, cache_k=tk, cache_v=tv, pos_offset=torch.as_tensor(off),
        compute_dtype=torch.float32)
    assert gk is tk and gv is tv
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)


def test_prefill_from_embeds_matches_jax():
    """``Model.prefill`` on {"embeds"}: the last logits and the cache."""
    cfg, jcfg, jm, jp, tm, tp = _models()
    e = _embeds(cfg, 2, 24, seed=5)
    jl, jc = jm.prefill(jp, {"embeds": jnp.asarray(e)})
    tl, tc = tm.prefill(tp, {"embeds": torch.as_tensor(e)})
    assert tl.shape == (2, 1, cfg.padded_vocab)
    _close(tl, jl)
    assert list(tc) == list(jc)
    for n in tc:
        _close(tc[n], jc[n])


def test_lm_forward_train_from_embeds_matches_jax():
    cfg, jcfg, jm, jp, tm, tp = _models()
    from repro.models import transformer as j_tf
    e = _embeds(cfg, 2, 24, seed=6)
    want, _, _ = j_tf.lm_forward(jp, jcfg, embeds=jnp.asarray(e),
                                 mode="train", compute_dtype=jnp.float32)
    got, _, _ = t_tf.lm_forward(tp, cfg, embeds=torch.as_tensor(e),
                                mode="train", compute_dtype=torch.float32)
    assert got.shape == (2, 24, cfg.padded_vocab)
    _close(got, want)


def test_decode_after_an_embeds_prefill_matches_jax():
    """Prefill 24 embedding rows, pad the cache to 40, then 8 greedy
    decode steps of text tokens through the embedding table: the same
    tokens every step, the logits and the caches within 1e-5."""
    cfg, jcfg, jm, jp, tm, tp = _models()
    from repro.models import transformer as j_tf
    S, B = 24, 2
    e = _embeds(cfg, B, S, seed=7)
    jl, jc = jm.prefill(jp, {"embeds": jnp.asarray(e)})
    tl, tc = tm.prefill(tp, {"embeds": torch.as_tensor(e)})
    jc = {n: jnp.pad(a, [(0, 0), (0, 0), (0, 40 - S), (0, 0), (0, 0)])
          for n, a in jc.items()}
    cache = tm.init_cache(B, 40, device="cpu")
    for n in cache:
        cache[n][:, :, :S] = tc[n]
    jt = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)
    tt = torch.argmax(tl[:, -1], -1).to(torch.int32)
    for i in range(8):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jlog, jc, _ = j_tf.lm_forward(
            jp, jcfg, tokens=jt[:, None], cache=jc,
            pos_offset=jnp.full((B,), S + i, jnp.int32), mode="decode",
            compute_dtype=jnp.float32, logits_mode="last")
        tlog, cache, _ = t_tf.lm_forward(
            tp, cfg, tokens=tt[:, None], cache=cache,
            pos_offset=torch.full((B,), S + i), mode="decode",
            compute_dtype=torch.float32, logits_mode="last")
        _close(tlog, jlog)
        jt = jnp.argmax(jlog[:, -1], -1).astype(jnp.int32)
        tt = torch.argmax(tlog[:, -1], -1).to(torch.int32)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    for n in cache:
        _close(cache[n], jc[n])


def test_decode_equals_a_longer_prefill():
    """The port alone: decoding token S after an S-row prefill gives
    the logits of a prefill of S + 1 rows whose last row is that token's
    embedding (text positions t = h = w on both paths)."""
    cfg, jcfg, jm, jp, tm, tp = _models()
    S, B = 16, 2
    e = torch.as_tensor(_embeds(cfg, B, S, seed=8))
    tok = torch.as_tensor(_tokens(cfg, B, 1, seed=9))
    _, c = tm.prefill(tp, {"embeds": e})
    cache = tm.init_cache(B, S + 1, device="cpu")
    for n in cache:
        cache[n][:, :, :S] = c[n]
    ld, _, _ = t_tf.lm_forward(tp, cfg, tokens=tok, cache=cache,
                               pos_offset=torch.full((B,), S),
                               mode="decode", compute_dtype=torch.float32,
                               logits_mode="last")
    long = torch.cat([e, tp["embed"][tok.long()]], 1)
    lf, _ = tm.prefill(tp, {"embeds": long})
    _close(ld, lf)


def test_lm_loss_on_embeds_matches_jax():
    """``Model.loss`` on {"embeds", "targets"}: the loss within 1e-5
    relative of the JAX package's, and its parts."""
    cfg, jcfg, jm, jp, tm, tp = _models()
    e = _embeds(cfg, 2, 24, seed=10)
    tgt = _tokens(cfg, 2, 24, seed=11)
    j_loss, j_parts = jm.loss(jp, {"embeds": jnp.asarray(e),
                                   "targets": jnp.asarray(tgt)})
    loss, parts = tm.loss(tp, {"embeds": torch.as_tensor(e),
                               "targets": torch.as_tensor(tgt)})
    assert float(loss) == pytest.approx(float(j_loss), rel=TOL)
    assert float(parts["ce"]) == pytest.approx(float(j_parts["ce"]),
                                               rel=TOL)
    assert float(parts["aux"]) == 0.0


def test_engine_on_text_prompts_matches_jax():
    """The port's ``Engine`` (CPU) and the JAX package's, one round of
    four text prompts of mixed lengths with 6 new tokens each through
    ``_serve_batch``: the same tokens."""
    cfg, jcfg, jm, jp, tm, tp = _models()
    B, max_seq = 4, 48
    rng = np.random.default_rng(12)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (9, 17, 12, 17)]
    eng = Engine(tm, tp, ServeConfig(batch_size=B, max_seq=max_seq,
                                     queue_capacity=8), device="cpu")
    jeng = JEngine(jm, jp, JServeConfig(batch_size=B, max_seq=max_seq,
                                        queue_capacity=8))
    try:
        got = [Request(rid=i, tokens=p, max_new=6)
               for i, p in enumerate(prompts)]
        want = [JRequest(rid=i, tokens=p, max_new=6)
                for i, p in enumerate(prompts)]
        eng._serve_batch(list(got))
        jeng._serve_batch(list(want))
    finally:
        eng.stop()
        jeng.stop()
    for g, w in zip(got, want):
        assert g.done.is_set() and w.done.is_set()
        np.testing.assert_array_equal(np.asarray(g.out), np.asarray(w.out))
