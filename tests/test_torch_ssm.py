"""The port's ssm family (mamba2) against the JAX package, on the CPU:
the block pieces, the whole model and the serving engine.

The JAX package initialises the weights and ``params_from_numpy``
carries them across; where the JAX init leaves ``A_log``, ``dt_bias``,
``D_skip`` and ``gnorm`` trivial (zeros and ones) the tests draw them
from numpy so that their precision shows.  Token ids come from numpy
with a seed.  The prefill's SSD runs the wrapper's plain version here
(CPU tensors).

Tolerances: float32 to 1e-4 (summation orders in XLA and PyTorch);
greedy tokens exactly; bf16 logits to 5e-2 (bf16 rounds at different
places in the two frameworks).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke
from repro.models import build_model as j_build_model
from repro.models import ssm as j_ssm
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import ssm as t_ssm
from repro_torch.serve import Engine, Request, ServeConfig

torch.set_num_threads(1)

ARCH = "mamba2-2.7b"
TOL = dict(rtol=1e-4, atol=1e-4)
F32_LEAVES = ("A_log", "dt_bias", "D_skip", "gnorm")


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _randomise_f32_leaves(tree, seed=0):
    """Non-trivial values for the leaves the JAX init sets to 0 or 1."""
    rng = np.random.default_rng(seed)
    blocks = dict(tree["blocks"])
    for name in F32_LEAVES:
        shape = blocks[name].shape
        base = 1.0 if name == "D_skip" else 0.0
        blocks[name] = (base + 0.3 * rng.standard_normal(shape)).astype(
            np.float32)
    return {**tree, "blocks": blocks}


_MODELS = {}


def _models(dtype, randomise=True):
    """(cfg, JAX model, JAX params, port model, port params) sharing one
    set of weights, on the smoke config (2 layers, d 64, N 16, P 16,
    chunk 8)."""
    key = (dtype, randomise)
    if key not in _MODELS:
        cfg = get_smoke_config(ARCH)
        jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        jm = j_build_model(j_get_smoke(ARCH), compute_dtype=jdt)
        tree = jax.tree_util.tree_map(
            np.asarray, jm.init_params(jax.random.PRNGKey(0)))
        if randomise:
            tree = _randomise_f32_leaves(tree)
        jp = jax.tree_util.tree_map(jnp.asarray, tree)
        tm = build_model(cfg, dtype)
        tp = params_from_numpy(cfg, tree, device="cpu", compute_dtype=dtype)
        _MODELS[key] = (cfg, jm, jp, tm, tp)
    return _MODELS[key]


def _tokens(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _layer0(tree):
    return {k: (v[0] if not isinstance(v, dict) else
                {kk: vv[0] for kk, vv in v.items()})
            for k, v in tree.items()}


# -- block pieces -------------------------------------------------------------

def test_causal_conv_and_decode_step_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 11, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    _close(t_ssm.causal_conv1d(torch.as_tensor(x), torch.as_tensor(w)),
           j_ssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w)))
    state = rng.standard_normal((2, 3, 24)).astype(np.float32)
    got = t_ssm.conv_decode_step(*map(torch.as_tensor, (x[:, 0], state, w)))
    want = j_ssm.conv_decode_step(*map(jnp.asarray, (x[:, 0], state, w)))
    for g, wv in zip(got, want):
        _close(g, wv)


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_block_matches_jax(with_state):
    """One block over a 13-token sequence (S % chunk != 0), fresh or
    continuing from carried conv and SSM states."""
    cfg, jm, jp, tm, tp = _models(torch.float32)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    kw_t, kw_j = {}, {}
    if with_state:
        conv = rng.standard_normal(
            (2, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state)
        ).astype(np.float32)
        ssm = rng.standard_normal(
            (2, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state)
        ).astype(np.float32)
        kw_t = dict(conv_state=torch.as_tensor(conv),
                    ssm_state=torch.as_tensor(ssm))
        kw_j = dict(conv_state=jnp.asarray(conv), ssm_state=jnp.asarray(ssm))
    out, (conv_s, ssm_s) = t_ssm.mamba_block(
        torch.as_tensor(x), _layer0(tp["blocks"]), cfg, torch.float32, **kw_t)
    wout, (wconv, wssm) = j_ssm.mamba_block(
        jnp.asarray(x), _layer0(jp["blocks"]), j_get_smoke(ARCH),
        jnp.float32, **kw_j)
    _close(out, wout)
    _close(conv_s, wconv)
    _close(ssm_s, wssm)


def test_mamba_decode_step_matches_jax():
    cfg, jm, jp, tm, tp = _models(torch.float32)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    conv = rng.standard_normal(
        (3, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state)
    ).astype(np.float32)
    ssm = rng.standard_normal(
        (3, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state)
    ).astype(np.float32)
    got = t_ssm.mamba_decode_step(
        torch.as_tensor(x), _layer0(tp["blocks"]), cfg,
        torch.as_tensor(conv), torch.as_tensor(ssm), torch.float32)
    want = j_ssm.mamba_decode_step(
        jnp.asarray(x), _layer0(jp["blocks"]), j_get_smoke(ARCH),
        jnp.asarray(conv), jnp.asarray(ssm), jnp.float32)
    _close(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        _close(g, w)


# -- the model ----------------------------------------------------------------

@pytest.mark.parametrize("S", [16, 13])
def test_prefill_matches_jax_f32(S):
    cfg, jm, jp, tm, tp = _models(torch.float32)
    toks = _tokens(cfg, 2, S)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.as_tensor(toks)})
    assert tl.shape == (2, 1, cfg.padded_vocab) and tl.dtype == torch.float32
    _close(tl, jl)
    assert set(tc) == {"conv", "ssm"}
    for n in tc:
        assert tuple(tc[n].shape) == tuple(jc[n].shape)
        _close(tc[n], jc[n])
    assert tc["ssm"].dtype == torch.float32


def test_greedy_decode_matches_jax_f32():
    """Prefill then 8 greedy decode steps: the same tokens in both
    packages, and the same states after them."""
    cfg, jm, jp, tm, tp = _models(torch.float32)
    toks = _tokens(cfg, 2, 11, seed=1)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.as_tensor(toks)})
    jt = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)
    tt = torch.argmax(tl[:, -1], -1).to(torch.int32)
    jpos, tpos = jnp.asarray([11, 11], jnp.int32), torch.tensor([11, 11])
    for _ in range(8):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jt, jc = jm.decode_step(jp, jc, jt, jpos)
        tt, tc = tm.decode_step(tp, tc, tt, tpos)
        jpos, tpos = jpos + 1, tpos + 1
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    for n in tc:
        _close(tc[n], jc[n])


def test_prefill_matches_jax_bf16():
    cfg, jm, jp, tm, tp = _models(torch.bfloat16)
    toks = _tokens(cfg, 2, 16, seed=2)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.as_tensor(toks)})
    assert tc["conv"].dtype == torch.bfloat16
    assert tc["ssm"].dtype == torch.float32
    _close(tl, jl, rtol=5e-2, atol=5e-2)


def test_params_carry_across_with_f32_leaves():
    """The JAX tree carries across unchanged; in a bf16 model the four
    leaves the block reads in float32 stay float32 and keep their
    values, the rest is held in bf16."""
    cfg, jm, jp, tm, tp = _models(torch.bfloat16)
    for name in F32_LEAVES:
        assert tp["blocks"][name].dtype == torch.float32
        np.testing.assert_array_equal(tp["blocks"][name].numpy(),
                                      np.asarray(jp["blocks"][name]))
    assert tp["blocks"]["w_x"].dtype == torch.bfloat16
    assert tp["blocks"]["ln"]["w"].dtype == torch.float32
    p = tm.init_params(torch.Generator().manual_seed(0), torch.bfloat16,
                       device="cpu")
    assert p["blocks"]["A_log"].dtype == torch.float32
    assert float(p["blocks"]["D_skip"].min()) == 1.0
    bad = jax.tree_util.tree_map(np.asarray, jp)
    bad["blocks"]["A_log"] = bad["blocks"]["A_log"][:, :3]
    with pytest.raises(ValueError):
        params_from_numpy(cfg, bad, device="cpu")


def test_full_width_config_builds_with_jax_shapes():
    """mamba2-2.7b at its published widths: the port's parameter and
    cache shapes equal the JAX package's (nothing is allocated)."""
    cfg, jcfg = get_config(ARCH), j_get_config(ARCH)
    tm = build_model(cfg)
    jm = j_build_model(jcfg)
    shapes = tm.param_shapes()
    jshapes = jax.tree_util.tree_map(lambda s: tuple(s.shape),
                                     jm.abstract_params())
    assert jax.tree_util.tree_leaves(shapes) == \
        jax.tree_util.tree_leaves(jshapes)
    assert shapes["blocks"]["w_x"] == (64, 2560, 5120)
    spec, axes = tm.cache_spec(8, 2048)
    jspec, jaxes = jm.cache_spec(8, 2048)
    for n in ("conv", "ssm"):
        assert spec[n][0] == tuple(jspec[n].shape)
        assert axes[n] == jaxes[n]
    assert spec["ssm"][0] == (64, 8, 80, 64, 128)
    assert spec["ssm"][1] == torch.float32
    assert spec["conv"][1] == torch.bfloat16


# -- the engine ---------------------------------------------------------------

B, S_MAX = 4, 32


def _engines(start_jax=False):
    cfg, jm, jp, tm, tp = _models(torch.float32)
    eng = Engine(tm, tp, ServeConfig(batch_size=B, max_seq=S_MAX,
                                     queue_capacity=16), device="cpu")
    jeng = JEngine(jm, jp, JServeConfig(batch_size=B, max_seq=S_MAX,
                                        queue_capacity=16))
    eng.start()
    if start_jax:
        jeng.start()
    return eng, jeng, cfg


@pytest.fixture(scope="module")
def pair():
    eng, jeng, cfg = _engines()
    yield eng, jeng, cfg
    eng.stop()
    jeng.stop()


def _prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
            for n in lens]


def _round(engine, req_cls, prompts, max_new):
    reqs = [req_cls(rid=i, tokens=p, max_new=m)
            for i, (p, m) in enumerate(zip(prompts, max_new))]
    engine._serve_batch(list(reqs))
    return [r.out for r in reqs]


def test_engine_equal_length_prompts_match_jax(pair):
    """Threaded serving across both lanes: each row's tokens do not
    depend on the round, so they equal the JAX engine's rounds."""
    eng, jeng, cfg = pair
    prompts = _prompts(cfg, [10] * 5, seed=3)
    reqs = [Request(rid=100 + i, tokens=p, max_new=6,
                    qos=("blocking", "nonblocking")[i % 2])
            for i, p in enumerate(prompts)]
    for r in reqs:
        assert eng.submit(r)
    for r in reqs:
        assert r.done.wait(timeout=120), "request timed out"
    want = (_round(jeng, JRequest, prompts[:B], [6] * B)
            + _round(jeng, JRequest, prompts[B:], [6]))
    for r, w in zip(reqs, want):
        np.testing.assert_array_equal(r.out, w)
    assert eng.stats()["crash_count"] == 0


@pytest.mark.parametrize("lens", [[5, 11, 9], [12, 6]])
def test_engine_mixed_lengths_match_jax(pair, lens):
    """Mixed lengths: a round right-pads its prompts with token 0, so a
    shorter prompt's state runs through the pad tokens — the reference's
    behaviour, reproduced token for token."""
    eng, jeng, cfg = pair
    prompts = _prompts(cfg, lens, seed=len(lens))
    got = _round(eng, Request, prompts, [5] * len(lens))
    want = _round(jeng, JRequest, prompts, [5] * len(lens))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _wait_until(cond, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


@pytest.mark.parametrize("length", ["conv", "short", "heads"])
def test_engine_pads_ssm_state_on_the_wrong_axis_like_jax(length):
    """The engine pads every cache leaf whose dim 2 equals the round's
    prompt length to max_seq.  For the ssm cache dim 2 is ssm_conv - 1
    (conv) and H (ssm), so a round whose longest prompt has exactly that
    many tokens gets a state padded along the wrong axis, and its decode
    raises.  A shorter prompt leaves a conv state of fewer than
    ssm_conv - 1 rows, again as long as the prompt, with the same end.
    Both engines record the crash and release the request with no
    answer."""
    eng, jeng, cfg = _engines(start_jax=True)
    try:
        n = {"conv": cfg.ssm_conv - 1, "short": 1,
             "heads": cfg.ssm_nheads}[length]
        (toks,) = _prompts(cfg, [n], seed=n)
        rt = Request(rid=0, tokens=toks, max_new=3)
        rj = JRequest(rid=0, tokens=toks, max_new=3)
        assert eng.submit(rt) and jeng.submit(rj)
        assert rt.done.wait(timeout=120) and rj.done.wait(timeout=120)
        assert rt.out is None and rj.out is None
        assert _wait_until(lambda: eng.stats()["crash_count"] == 1
                           and jeng.stats()["crash_count"] == 1)
        # one token more (at least ssm_conv) is served
        (ok,) = _prompts(cfg, [max(n + 1, cfg.ssm_conv)], seed=n)
        got = _round(eng, Request, [ok], [3])
        want = _round(jeng, JRequest, [ok], [3])
        np.testing.assert_array_equal(got[0], want[0])
    finally:
        eng.stop()
        jeng.stop()
