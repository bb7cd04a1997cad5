"""The port's MoE block and MoE LM against the JAX package, on the CPU.

The JAX package initialises the ``phi3p5-moe-smoke`` weights (2 layers,
d 64, 4/2 heads x 16, 4 experts top-2 of d_ff 96, SwiGLU);
``params_from_numpy`` carries them into the port in the same layout.
Inputs come from numpy with a seed.  The attention runs the flash op's
plain version here (CPU tensors).

Tolerances: float32 block outputs, router probabilities, logits and
caches to 1e-4 (the existing parity tests' rtol = atol); greedy tokens
exactly; the loss and the router aux to 1e-5 relative and every
gradient leaf to 1e-4 relative L2 (XLA's and PyTorch's summation
orders); bf16 logits to 5e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke
from repro.models import build_model as j_build_model
from repro.models import moe as j_moe
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as t_tf
from repro_torch.serve import Engine, Request, ServeConfig
from repro_torch.train.optimizer import _leaves

torch.set_num_threads(1)

ARCH = "phi3.5-moe-42b-a6.6b"

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


def _layer0(jp, tp):
    return (jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["moe"]),
            {k: v[0] for k, v in tp["blocks"]["moe"].items()})


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _close(a, b, tol=1e-4):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol,
                               atol=tol)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _overflowing_rows(cfg, S, seed):
    """Row 0: independent tokens; row 1: one token repeated, so its two
    experts each get S slots, past the capacity."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    x[1] = x[1, :1]
    return x


@pytest.mark.parametrize("S", [1, 12, 32])
def test_moe_block_matches_jax(S):
    cfg, jm, jp, tm, tp = _models(torch.float32)
    j_p, t_p = _layer0(jp, tp)
    x = _overflowing_rows(cfg, S, seed=S)
    C = t_moe._capacity(cfg, S)
    assert C == j_moe._capacity(cfg, S)
    if S == 32:
        assert S > C         # row 1 drops S - C slots at each expert
    want_y, want_p = j_moe.moe_block(jnp.asarray(x), j_p, cfg, jnp.float32)
    got_y, got_p = t_moe.moe_block(torch.as_tensor(x), t_p, cfg,
                                   torch.float32)
    assert got_y.shape == x.shape and got_p.shape == (2, S, cfg.n_experts)
    _close(got_p.numpy(), want_p)
    _close(got_y.numpy(), want_y)


def test_capacity_drops_reach_the_output():
    """In an overflowing row the tokens past the capacity get nothing
    from their experts (both packages): their outputs are zero."""
    cfg, jm, jp, tm, tp = _models(torch.float32)
    _, t_p = _layer0(jp, tp)
    S = 32
    C = t_moe._capacity(cfg, S)
    y, _ = t_moe.moe_block(torch.as_tensor(_overflowing_rows(cfg, S, 3)),
                           t_p, cfg, torch.float32)
    assert float(y[1, C:].abs().max()) == 0.0
    assert float(y[1, :C].abs().min()) > 0.0


def test_router_aux_loss_matches_jax():
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((3, 10, 4)).astype(np.float32)
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    want = j_moe.router_aux_loss(jnp.asarray(probs))
    got = t_moe.router_aux_loss(torch.as_tensor(probs))
    assert float(got) == pytest.approx(float(want), rel=1e-5)


@pytest.mark.parametrize("remat", [None, "full"])
def test_lm_loss_with_aux_and_grads_match_jax(remat):
    cfg, jm, jp, tm, tp = _models(torch.float32)
    toks = _tokens(cfg, 2, 17, seed=1)
    b = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    (j_loss, j_mets), j_grads = jax.value_and_grad(
        jm.loss, has_aux=True)(jp, {k: jnp.asarray(v) for k, v in b.items()})
    leaves = _leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, mets = tm.loss(tp, {k: torch.as_tensor(v)
                                  for k, v in b.items()},
                             remat_policy=remat)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    aux = float(mets["aux"].detach())
    assert aux > 0.0
    assert aux == pytest.approx(float(j_mets["aux"]), rel=1e-5)
    assert float(mets["ce"].detach()) == pytest.approx(float(j_mets["ce"]),
                                                     rel=1e-5)
    assert float(loss.detach()) == pytest.approx(float(j_loss), rel=1e-5)
    j_leaves = jax.tree_util.tree_leaves(j_grads)
    assert len(grads) == len(j_leaves)
    for g, jg in zip(grads, j_leaves):
        assert g.shape == jg.shape
        assert _rel_l2(g.numpy(), jg) <= 1e-4


def test_prefill_and_greedy_decode_match_jax_f32():
    """Prefill 9 tokens, pad the cache to 32, 4 greedy decode steps (an
    MoE layer at S = 1): the same tokens, the caches equal."""
    cfg, jm, jp, tm, tp = _models(torch.float32)
    toks = _tokens(cfg, 2, 9, seed=2)
    L, S = 9, 32
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.as_tensor(toks)})
    _close(tl.numpy(), jl)
    for n in ("k", "v"):
        _close(tc[n].numpy(), jc[n])
    jc = {n: jnp.pad(a, [(0, 0), (0, 0), (0, S - L), (0, 0), (0, 0)])
          for n, a in jc.items()}
    cache = tm.init_cache(2, S, device="cpu")
    for n in cache:
        cache[n][:, :, :L] = tc[n]
    jt = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)
    tt = torch.argmax(tl[:, -1], -1).to(torch.int32)
    jpos, tpos = jnp.full((2,), L, jnp.int32), torch.full((2,), L)
    for _ in range(4):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jt, jc = jm.decode_step(jp, jc, jt, jpos)
        tt, cache = tm.decode_step(tp, cache, tt, tpos)
        jpos, tpos = jpos + 1, tpos + 1
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    _close(cache["v"].numpy(), jc["v"])


def test_prefill_matches_jax_bf16():
    cfg, jm, jp, tm, tp = _models(torch.bfloat16)
    assert tp["blocks"]["moe"]["w_gate"].dtype == torch.bfloat16
    toks = _tokens(cfg, 2, 16, seed=3)
    jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, _ = tm.prefill(tp, {"tokens": torch.as_tensor(toks)})
    _close(tl.numpy(), jl, tol=5e-2)


def test_lm_forward_sums_the_router_aux_over_layers(monkeypatch):
    cfg, jm, jp, tm, tp = _models(torch.float32)
    toks = torch.as_tensor(_tokens(cfg, 2, 8, seed=4))
    _, _, aux = t_tf.lm_forward(tp, cfg, tokens=toks,
                                compute_dtype=torch.float32)
    per, orig = [], t_tf.router_aux_loss

    def spy(probs):
        per.append(orig(probs))
        return per[-1]
    monkeypatch.setattr(t_tf, "router_aux_loss", spy)
    t_tf.lm_forward(tp, cfg, tokens=toks, compute_dtype=torch.float32)
    assert len(per) == cfg.n_layers
    assert float(aux) == pytest.approx(float(sum(per)), rel=1e-6)


def test_engine_serves_the_moe_model():
    """``serve.Engine`` on the MoE model: requests of equal length come
    back with the direct greedy decode's tokens."""
    cfg, jm, jp, tm, tp = _models(torch.float32)
    eng = Engine(tm, tp, ServeConfig(batch_size=2, max_seq=32,
                                     queue_capacity=8), device="cpu")
    toks = _tokens(cfg, 1, 6, seed=5)[0]
    reqs = [Request(rid=i, tokens=toks, max_new=4) for i in range(2)]
    eng.start()
    try:
        for r in reqs:
            assert eng.submit(r, timeout=30.0)
        for r in reqs:
            assert r.done.wait(timeout=120)
        assert not eng._crashes
    finally:
        eng.stop()
    jt = []
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(np.stack([toks] * 2))})
    jc = {n: jnp.pad(a, [(0, 0), (0, 0), (0, 32 - 6), (0, 0), (0, 0)])
          for n, a in jc.items()}
    cur = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)
    pos = jnp.full((2,), 6, jnp.int32)
    for _ in range(4):
        jt.append(int(cur[0]))
        cur, jc = jm.decode_step(jp, jc, cur, pos)
        pos = pos + 1
    for r in reqs:
        np.testing.assert_array_equal(r.out, np.asarray(jt, np.int32))


@pytest.mark.parametrize("kind", ["smoke", "full"])
def test_param_shapes_match_the_reference(kind):
    cfg = (get_smoke_config if kind == "smoke" else get_config)(ARCH)
    jcfg = (j_get_smoke if kind == "smoke" else j_get_config)(ARCH)
    shapes = jax.tree_util.tree_map(lambda s: tuple(s.shape),
                                    j_build_model(jcfg).abstract_params())
    assert build_model(cfg).param_shapes() == shapes
