"""The port's encoder-decoder (Whisper) against the JAX package, on the
CPU.

The JAX package initialises the ``whisper-smoke`` weights (2 + 2
layers, d 64, 4 heads x 16, encoder_seq 16); ``params_from_numpy``
carries them into the port in the same layout.  Frames and token ids
come from numpy with a seed.  The attention runs the flash op's plain
version here (CPU tensors), with its plain backward.

Tolerances: float32 encoder states, logits and caches to 1e-4 (the
existing parity tests' rtol = atol); greedy tokens exactly; the loss to
1e-5 relative and every gradient leaf to 1e-4 relative L2 (XLA's and
PyTorch's summation orders); bf16 logits to 5e-2 (bf16 rounds at
different places in the two frameworks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke
from repro.models import build_model as j_build_model
from repro.models import whisper as j_whisper
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import whisper as t_whisper
from repro_torch.train.optimizer import _leaves

torch.set_num_threads(1)

ARCH = "whisper-large-v3"

_MODELS = {}


def _models(dtype):
    """(config, JAX model, JAX params, port model, port params) on one
    set of weights; float32 master weights for the float32 port."""
    if dtype not in _MODELS:
        cfg, jcfg = get_smoke_config(ARCH), j_get_smoke(ARCH)
        jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        jm = j_build_model(jcfg, compute_dtype=jdt)
        jp = jm.init_params(jax.random.PRNGKey(0))
        tree = jax.tree_util.tree_map(np.asarray, jp)
        tm = build_model(cfg, dtype)
        tp = params_from_numpy(cfg, tree, device="cpu", compute_dtype=dtype,
                               param_dtype=torch.float32
                               if dtype == torch.float32 else None)
        _MODELS[dtype] = (cfg, jm, jp, tm, tp)
    return _MODELS[dtype]


def _inputs(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return {"frames": rng.standard_normal(
                (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size,
                                   (B, S)).astype(np.int32)}


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close(a, b, tol=1e-4):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol,
                               atol=tol)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_encode_matches_jax_f32():
    cfg, jm, jp, tm, tp = _models(torch.float32)
    b = _inputs(cfg, 2, 4, seed=0)
    want = j_whisper.whisper_encode(jp, cfg, jnp.asarray(b["frames"]),
                                    jnp.float32)
    got = t_whisper.whisper_encode(tp, cfg, torch.as_tensor(b["frames"]),
                                   torch.float32)
    assert got.shape == (2, cfg.encoder_seq, cfg.d_model)
    _close(got.numpy(), want)


@pytest.mark.parametrize("S", [1, 7])
def test_prefill_logits_and_cache_match_jax_f32(S):
    cfg, jm, jp, tm, tp = _models(torch.float32)
    b = _inputs(cfg, 2, S, seed=S)
    jl, jc = jm.prefill(jp, _j(b))
    tl, tc = tm.prefill(tp, _t(b))
    assert tl.shape == (2, 1, cfg.padded_vocab) and tl.dtype == torch.float32
    _close(tl.numpy(), jl)
    assert sorted(tc) == ["ck", "cv", "k", "v"]
    for n in ("k", "v"):
        assert tc[n].shape == (cfg.n_layers, 2, S, cfg.n_kv_heads,
                               cfg.head_dim)
    for n in ("ck", "cv"):
        assert tc[n].shape == (cfg.n_layers, 2, cfg.encoder_seq,
                               cfg.n_kv_heads, cfg.head_dim)
    for n in tc:
        _close(tc[n].numpy(), jc[n])


def test_greedy_decode_over_the_static_cross_cache_matches_jax_f32():
    """Prefill 5 tokens, pad the self-attention cache to 24 (the cross
    cache stays as the prefill left it), then 6 greedy decode steps: the
    same tokens in both packages, the caches equal, the cross cache
    unchanged."""
    cfg, jm, jp, tm, tp = _models(torch.float32)
    b = _inputs(cfg, 3, 5, seed=11)
    L, S = 5, 24
    jl, jc = jm.prefill(jp, _j(b))
    tl, tc = tm.prefill(tp, _t(b))
    jc = {n: (jnp.pad(a, [(0, 0), (0, 0), (0, S - L), (0, 0), (0, 0)])
              if n in ("k", "v") else a) for n, a in jc.items()}
    cache = tm.init_cache(3, S, device="cpu")
    assert cache["ck"].shape == tc["ck"].shape
    for n in ("k", "v"):
        cache[n][:, :, :L] = tc[n]
    for n in ("ck", "cv"):
        cache[n].copy_(tc[n])
    cross = cache["ck"].clone()
    jt = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)
    tt = torch.argmax(tl[:, -1], -1).to(torch.int32)
    jpos, tpos = jnp.full((3,), L, jnp.int32), torch.full((3,), L)
    for _ in range(6):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jt, jc = jm.decode_step(jp, jc, jt, jpos)
        tt, cache = tm.decode_step(tp, cache, tt, tpos)
        jpos, tpos = jpos + 1, tpos + 1
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    for n in ("k", "v", "cv"):
        _close(cache[n].numpy(), jc[n])
    assert torch.equal(cache["ck"], cross)


def test_decode_agrees_with_prefill_f32():
    """As the JAX package's ``test_decode_matches_prefill``: prefill S - 1
    tokens and decode the last one gives the full prefill's token."""
    cfg, jm, jp, tm, tp = _models(torch.float32)
    b = _inputs(cfg, 2, 12, seed=2)
    full, _ = tm.prefill(tp, _t(b))
    part = dict(_t(b), tokens=torch.as_tensor(b["tokens"][:, :-1]))
    _, c = tm.prefill(tp, part)
    cache = tm.init_cache(2, 12, device="cpu")
    for n in c:
        cache[n][:, :, :c[n].shape[2]] = c[n]
    nt, _ = tm.decode_step(tp, cache, torch.as_tensor(b["tokens"][:, -1]),
                           torch.full((2,), 11))
    assert torch.equal(nt, torch.argmax(full[:, -1], -1).to(torch.int32))


@pytest.mark.parametrize("remat", [None, "full"])
def test_whisper_loss_and_grads_match_jax(remat):
    cfg, jm, jp, tm, tp = _models(torch.float32)
    b = _inputs(cfg, 2, 9, seed=4)
    b["targets"] = np.roll(b["tokens"], -1, axis=1)
    (j_loss, j_mets), j_grads = jax.value_and_grad(
        jm.loss, has_aux=True)(jp, _j(b))
    leaves = _leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, mets = tm.loss(tp, _t(b), remat_policy=remat)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    assert float(loss.detach()) == pytest.approx(float(j_loss), rel=1e-5)
    assert float(mets["ce"].detach()) == pytest.approx(float(j_mets["ce"]),
                                                     rel=1e-5)
    assert float(mets["aux"]) == 0.0
    j_leaves = jax.tree_util.tree_leaves(j_grads)
    assert len(grads) == len(j_leaves)
    for g, jg in zip(grads, j_leaves):
        assert g.shape == jg.shape
        assert _rel_l2(g.numpy(), jg) <= 1e-4


def test_prefill_matches_jax_bf16():
    cfg, jm, jp, tm, tp = _models(torch.bfloat16)
    assert tp["dec_blocks"]["xattn"]["wk"].dtype == torch.bfloat16
    for path in (("dec_blocks", "ln_x", "w"), ("enc_norm", "b"),
                 ("enc_blocks", "ln1", "w"), ("final_norm", "w")):
        leaf = tp
        for k in path:
            leaf = leaf[k]
        assert leaf.dtype == torch.float32, path
    b = _inputs(cfg, 2, 6, seed=5)
    jl, _ = jm.prefill(jp, _j(b))
    tl, tc = tm.prefill(tp, _t(b))
    assert tc["ck"].dtype == torch.bfloat16
    _close(tl.numpy(), jl, tol=5e-2)


@pytest.mark.parametrize("kind", ["smoke", "full"])
def test_cache_spec_and_params_match_the_reference(kind):
    from repro.configs import get_config as j_get_config
    cfg = (get_smoke_config if kind == "smoke" else get_config)(ARCH)
    jcfg = (j_get_smoke if kind == "smoke" else j_get_config)(ARCH)
    tm, jm = build_model(cfg), j_build_model(jcfg)
    spec, axes = tm.cache_spec(4, 32)
    j_spec, j_axes = jm.cache_spec(4, 32)
    assert list(spec) == list(j_spec) and axes == j_axes
    for n, (shape, dtype) in spec.items():
        assert shape == j_spec[n].shape and dtype == torch.bfloat16
    shapes = jax.tree_util.tree_map(lambda s: tuple(s.shape),
                                    jm.abstract_params())
    assert tm.param_shapes() == shapes


def test_dec_pos_past_the_table_raises():
    """The port indexes the learned positions, so a position past
    ``learned_positions`` raises (the JAX package's ``jnp.take`` fills
    NaN there)."""
    cfg, jm, jp, tm, tp = _models(torch.float32)
    toks = torch.zeros((1, cfg.learned_positions + 1), dtype=torch.int32)
    with pytest.raises(IndexError):
        t_whisper.whisper_forward(tp, cfg, tokens=toks,
                                  enc_out=torch.zeros(1, 4, cfg.d_model),
                                  compute_dtype=torch.float32)
