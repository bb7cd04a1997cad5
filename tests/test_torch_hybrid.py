"""The port's hybrid family (zamba2) against the JAX package, on the CPU:
G groups of mamba layers, each followed by the one shared attention+MLP
block, its parameters, its cache, prefill, decode, the loss and its
gradients, and the serving engine.

The JAX package initialises the ``zamba2-smoke`` weights (9 layers as 3
groups of 2 mamba layers and the shared block, d 64, 4 heads x 16, N 16,
P 16, chunk 8); ``params_from_numpy`` carries them across, and the
leaves the JAX init leaves trivial (``A_log``, ``dt_bias``, ``D_skip``,
``gnorm``) are drawn from numpy so that their precision shows.  Token
ids come from numpy with a seed.  The prefill's attention and SSD run
the wrappers' plain versions here (CPU tensors).

Tolerances, as ``test_torch_ssm.py`` and ``test_torch_moe.py`` use them
for the same outputs: float32 logits and caches to 1e-4; greedy tokens
exactly; the loss to 1e-5 relative and every gradient leaf to 1e-4
relative L2; bf16 logits to 5e-2 at one group, and deeper within 1.5x
the JAX package's own bf16 error (``test_prefill_matches_jax_bf16``).
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke
from repro.models import build_model as j_build_model
from repro.models import transformer as j_tf
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import transformer as t_tf
from repro_torch.serve import Engine, Request, ServeConfig
from repro_torch.train.optimizer import _leaves

torch.set_num_threads(1)

ARCH = "zamba2-7b"
TOL = dict(rtol=1e-4, atol=1e-4)
F32_LEAVES = ("A_log", "dt_bias", "D_skip", "gnorm")
S = 24                       # three SSD chunks of 8


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


_MODELS = {}


def _models(dtype):
    """(cfg, JAX model, JAX params, port model, port params) sharing one
    set of weights; float32 master weights for the float32 port."""
    if dtype not in _MODELS:
        cfg = get_smoke_config(ARCH)
        jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        jm = j_build_model(j_get_smoke(ARCH), compute_dtype=jdt)
        tree = jax.tree_util.tree_map(
            np.asarray, jm.init_params(jax.random.PRNGKey(0)))
        rng = np.random.default_rng(0)
        mamba = dict(tree["mamba"])
        for name in F32_LEAVES:
            base = 1.0 if name == "D_skip" else 0.0
            mamba[name] = (base + 0.3 * rng.standard_normal(
                mamba[name].shape)).astype(np.float32)
        tree = {**tree, "mamba": mamba}
        jp = jax.tree_util.tree_map(jnp.asarray, tree)
        tm = build_model(cfg, dtype)
        tp = params_from_numpy(cfg, tree, device="cpu", compute_dtype=dtype,
                               param_dtype=torch.float32
                               if dtype == torch.float32 else None)
        _MODELS[dtype] = (cfg, jm, jp, tm, tp)
    return _MODELS[dtype]


def _tokens(cfg, B, L, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, L)).astype(np.int32)


def _pad_kv(cache, L, max_seq, xp):
    """The engine's decode cache: k/v padded on dim 2 to max_seq, the
    conv and SSM states as the prefill left them."""
    pad = [(0, 0), (0, 0), (0, max_seq - L), (0, 0), (0, 0)]
    return {n: (xp.pad(a, pad) if n in ("k", "v") else a)
            for n, a in cache.items()}


# -- parameters and caches ---------------------------------------------------

@pytest.mark.parametrize("kind", ["smoke", "full"])
def test_param_shapes_and_axes_match_jax(kind):
    """The tree {"embed", "final_norm", "unembed", "mamba": (G per, ...),
    "shared": one block}: the reference's shapes and logical axes."""
    cfg = (get_smoke_config if kind == "smoke" else get_config)(ARCH)
    jm = j_build_model((j_get_smoke if kind == "smoke"
                        else j_get_config)(ARCH))
    tm = build_model(cfg)
    jshapes = jax.tree_util.tree_map(lambda s: tuple(s.shape),
                                     jm.abstract_params())
    assert tm.param_shapes() == jshapes
    axes = tm._defs(lambda path, shape, ax, fan_in=None, kind="normal":
                    tuple(ax))
    assert axes == jm.param_axes()
    assert set(jshapes) == {"embed", "final_norm", "unembed", "mamba",
                            "shared"}
    if kind == "full":
        assert jshapes["mamba"]["w_x"] == (72, 3584, 7168)
        assert jshapes["shared"]["attn"]["wq"] == (3584, 32, 112)


@pytest.mark.parametrize("kind", ["smoke", "full"])
def test_cache_spec_matches_jax(kind):
    """conv (G, per, B, K-1, d_inner + 2N) in the compute dtype, ssm (G,
    per, B, H, P, N) float32, k/v (G, B, max_seq, K, hd): the
    reference's shapes and axes; ``init_cache`` allocates them."""
    cfg = (get_smoke_config if kind == "smoke" else get_config)(ARCH)
    jm = j_build_model((j_get_smoke if kind == "smoke"
                        else j_get_config)(ARCH))
    tm = build_model(cfg)
    spec, axes = tm.cache_spec(8, 2048)
    jspec, jaxes = jm.cache_spec(8, 2048)
    assert list(spec) == list(jspec) and axes == jaxes
    for n in spec:
        assert spec[n][0] == tuple(jspec[n].shape)
    assert spec["ssm"][1] == torch.float32
    assert spec["conv"][1] == spec["k"][1] == torch.bfloat16
    if kind == "full":
        assert spec["ssm"][0] == (9, 8, 8, 112, 64, 64)
        assert spec["k"][0] == (9, 8, 2048, 32, 112)
    else:
        cache = tm.init_cache(2, 16, device="cpu")
        assert {n: tuple(t.shape) for n, t in cache.items()} == {
            n: tuple(s.shape) for n, s in jm.cache_spec(2, 16)[0].items()}


def test_params_carry_across_with_f32_leaves():
    """In a bf16 model the mamba leaves the block reads in float32 and
    the norms stay float32 and keep their values; the rest is bf16."""
    cfg, jm, jp, tm, tp = _models(torch.bfloat16)
    for name in F32_LEAVES:
        assert tp["mamba"][name].dtype == torch.float32
        np.testing.assert_array_equal(tp["mamba"][name].numpy(),
                                      np.asarray(jp["mamba"][name]))
    assert tp["mamba"]["w_x"].dtype == torch.bfloat16
    assert tp["mamba"]["ln"]["w"].dtype == torch.float32
    assert tp["shared"]["attn"]["wq"].dtype == torch.bfloat16
    assert tp["shared"]["ln1"]["w"].dtype == torch.float32


# -- the model ----------------------------------------------------------------

def test_lm_forward_train_matches_jax():
    cfg, jm, jp, tm, tp = _models(torch.float32)
    toks = _tokens(cfg, 2, S, seed=1)
    want, _, _ = j_tf.lm_forward(jp, j_get_smoke(ARCH),
                                 tokens=jnp.asarray(toks), mode="train",
                                 compute_dtype=jnp.float32)
    got, cache, aux = t_tf.lm_forward(tp, cfg, tokens=torch.as_tensor(toks),
                                      mode="train",
                                      compute_dtype=torch.float32)
    assert cache is None and float(aux) == 0.0
    assert got.shape == (2, S, cfg.padded_vocab)
    _close(got, want)


@pytest.mark.parametrize("L", [S, 29])
def test_prefill_matches_jax_f32(L):
    """The last logits and every cache leaf, S a whole number of chunks
    and not."""
    cfg, jm, jp, tm, tp = _models(torch.float32)
    toks = _tokens(cfg, 2, L, seed=L)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.as_tensor(toks)})
    assert tl.shape == (2, 1, cfg.padded_vocab)
    _close(tl, jl)
    assert list(tc) == list(jc)
    for n in tc:
        assert tuple(tc[n].shape) == tuple(jc[n].shape), n
        _close(tc[n], jc[n])


def test_greedy_decode_matches_jax_f32():
    """Prefill 24 tokens, pad the KV cache to 40, then 8 greedy decode
    steps: the same tokens, and every cache leaf equal after them."""
    cfg, jm, jp, tm, tp = _models(torch.float32)
    toks = _tokens(cfg, 2, S, seed=2)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.as_tensor(toks)})
    jc = _pad_kv(jc, S, 40, jnp)
    cache = tm.init_cache(2, 40, device="cpu")
    for n in cache:
        if n in ("k", "v"):
            cache[n][:, :, :S] = tc[n]
        else:
            cache[n].copy_(tc[n])
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


@pytest.mark.parametrize("remat", [None, "full"])
def test_lm_loss_and_grads_match_jax(remat):
    """``lm_loss`` and the gradient of every leaf (the mamba stack, the
    shared block summed over its G applications) against
    ``jax.value_and_grad``; remat "full" recomputes each group."""
    cfg, jm, jp, tm, tp = _models(torch.float32)
    toks = _tokens(cfg, 2, S + 1, seed=3)
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


@pytest.mark.parametrize("groups", [1, 3])
def test_prefill_matches_jax_bf16(groups):
    """bf16 prefill logits.  At one group (2 mamba layers and the shared
    block, the depth of the ssm and MoE files' bf16 tests) to 5e-2, as
    there.  bf16 rounds at different places in the two frameworks and
    the difference grows with depth: at the smoke config's 3 groups each
    package's bf16 logits sit ~0.2 (max abs) from its float32 ones, so
    there the gate is the JAX package's own bf16 error: the port's bf16
    logits within 1.5x the rel L2 of JAX's bf16 from JAX's float32."""
    cfg, jm, jp, tm, tp = _models(torch.bfloat16)
    toks = jnp.asarray(_tokens(cfg, 2, S, seed=4))
    if groups == 1:
        cut = dict(n_layers=cfg.hybrid_group + 1)
        cfg = dataclasses.replace(cfg, **cut)
        jm = j_build_model(dataclasses.replace(j_get_smoke(ARCH), **cut),
                           compute_dtype=jnp.bfloat16)
        tm = build_model(cfg, torch.bfloat16)
        jp = {**jp, "mamba": jax.tree_util.tree_map(
            lambda a: a[:cfg.hybrid_group], jp["mamba"])}
        tp = {**tp, "mamba": {k: (v[:cfg.hybrid_group] if not isinstance(
            v, dict) else {kk: vv[:cfg.hybrid_group] for kk, vv in v.items()})
            for k, v in tp["mamba"].items()}}
    jl, _ = jm.prefill(jp, {"tokens": toks})
    tl, tc = tm.prefill(tp, {"tokens": torch.as_tensor(np.array(toks))})
    assert tc["conv"].dtype == tc["k"].dtype == torch.bfloat16
    assert tc["ssm"].dtype == torch.float32
    if groups == 1:
        _close(tl, jl, rtol=5e-2, atol=5e-2)
        return
    _, _, jp32, _, _ = _models(torch.float32)
    j32 = j_build_model(j_get_smoke(ARCH), compute_dtype=jnp.float32)
    jl32, _ = j32.prefill(jp32, {"tokens": toks})
    floor = _rel_l2(np.asarray(jl, np.float32), jl32)
    assert _rel_l2(tl.float().numpy(), np.asarray(jl, np.float32)) \
        <= 1.5 * floor


def test_each_group_runs_its_mamba_layers_then_the_shared_block(
        monkeypatch):
    """A forward runs G x per mamba layers and G applications of the
    shared block, each with no window and the same parameters, in the
    order of the reference's scan."""
    cfg, jm, jp, tm, tp = _models(torch.float32)
    calls = []
    mamba, attn = t_tf._mamba_layer, t_tf._attn_mlp_layer

    def spy_mamba(cfg_, x, bp, *a, **k):
        calls.append(("mamba", bp["w_x"].data_ptr()))
        return mamba(cfg_, x, bp, *a, **k)

    def spy_attn(cfg_, x, bp, positions, is_local, *a, **k):
        assert is_local is None
        calls.append(("shared", bp["attn"]["wq"].data_ptr()))
        return attn(cfg_, x, bp, positions, is_local, *a, **k)
    monkeypatch.setattr(t_tf, "_mamba_layer", spy_mamba)
    monkeypatch.setattr(t_tf, "_attn_mlp_layer", spy_attn)
    tm.prefill(tp, {"tokens": torch.as_tensor(_tokens(cfg, 1, 9))})
    G, per = 3, 2
    assert [c[0] for c in calls] == (["mamba"] * per + ["shared"]) * G
    w_x = tp["mamba"]["w_x"]
    mamba_ptrs = [c[1] for c in calls if c[0] == "mamba"]
    assert mamba_ptrs == [w_x[i].data_ptr() for i in range(G * per)]
    assert len({c[1] for c in calls if c[0] == "shared"}) == 1


# -- the engine ---------------------------------------------------------------

B, MAX_SEQ = 2, 48


def _jax_direct(jm, jp, rows, max_new):
    """Greedy prefill + decode of one round in the JAX package, as its
    engine runs it."""
    L = rows.shape[1]
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(rows)})
    jc = _pad_kv(jc, L, MAX_SEQ, jnp)
    cur = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)
    pos = jnp.full((rows.shape[0],), L, jnp.int32)
    out = []
    for _ in range(max_new):
        out.append(np.asarray(cur))
        cur, jc = jm.decode_step(jp, jc, cur, pos)
        pos = pos + 1
    return np.stack(out, 1)


def test_engine_round_equals_the_direct_decode():
    """``serve.Engine`` on the hybrid: a round prefills (its KV cache
    padded on dim 2, its conv and SSM states as they are) and decodes;
    each request's tokens equal the JAX package's direct greedy decode
    of the same round."""
    cfg, jm, jp, tm, tp = _models(torch.float32)
    eng = Engine(tm, tp, ServeConfig(batch_size=B, max_seq=MAX_SEQ,
                                     queue_capacity=8), device="cpu")
    rows = _tokens(cfg, B, S + 3, seed=5)
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
    want = _jax_direct(jm, jp, rows, 6)
    for i, r in enumerate(reqs):
        np.testing.assert_array_equal(r.out, want[i])


def _wait_until(cond, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


def test_engine_round_of_batch_length_crashes_like_jax():
    """The engine pads every cache leaf whose dim 2 equals the round's
    prompt length L.  The hybrid's conv and SSM states hold the batch on
    dim 2, so a round with L == B pads them along the wrong axis and its
    decode raises, in both packages; one token more is served, equal to
    the reference's."""
    cfg, jm, jp, tm, tp = _models(torch.float32)
    eng = Engine(tm, tp, ServeConfig(batch_size=B, max_seq=MAX_SEQ,
                                     queue_capacity=8), device="cpu")
    jeng = JEngine(jm, jp, JServeConfig(batch_size=B, max_seq=MAX_SEQ,
                                        queue_capacity=8))
    eng.start()
    jeng.start()
    try:
        toks = _tokens(cfg, 1, B, seed=6)[0]
        rt = Request(rid=0, tokens=toks, max_new=3)
        rj = JRequest(rid=0, tokens=toks, max_new=3)
        assert eng.submit(rt) and jeng.submit(rj)
        assert rt.done.wait(timeout=120) and rj.done.wait(timeout=120)
        assert rt.out is None and rj.out is None
        assert _wait_until(lambda: eng.stats()["crash_count"] == 1
                           and jeng.stats()["crash_count"] == 1)
        ok = _tokens(cfg, 1, B + 1, seed=7)[0]
        rt = Request(rid=1, tokens=ok, max_new=3)
        rj = JRequest(rid=1, tokens=ok, max_new=3)
        assert eng.submit(rt) and jeng.submit(rj)
        assert rt.done.wait(timeout=120) and rj.done.wait(timeout=120)
        np.testing.assert_array_equal(rt.out, rj.out)
    finally:
        eng.stop()
        jeng.stop()
