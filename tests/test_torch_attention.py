"""The port's flash-attention op against the JAX package, on the CPU:
the forward, and its gradients through ``FlashAttentionFn``.

On CPU tensors the op runs its plain PyTorch version (the Hopper kernel
runs only on the card: ``tests/test_torch_cuda_kernels.py``).  Inputs are
made with numpy from a seed and handed to both packages.  The JAX side
is ``attention_ref``: the Pallas wrapper ``flash_attention_pallas`` does
not run on the installed jax (ROADMAP.md, Queue 3).  Tolerances are the
JAX package's own flash-attention ones (``tests/test_kernels.py``):
2e-4 for float32 inputs, 5e-2 for bf16 inputs against float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention.ref import attention_ref as j_attention_ref
from repro_torch.kernels.attention import flash_attention
from repro_torch.kernels.attention import kernel as K
from repro_torch.kernels.attention import ops as O
from repro_torch.kernels.attention.ref import (attention_bwd_ref,
                                               attention_lse_ref,
                                               attention_ref)

# the test workers share the machine: one PyTorch CPU thread per file
torch.set_num_threads(1)

SHAPES = [(1, 128, 2, 2, 32), (2, 256, 4, 2, 32), (1, 256, 8, 8, 64)]


def _qkv(shape, seed, T=None):
    B, S, H, K_, hd = shape
    T = S if T is None else T
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, T, K_, hd)).astype(np.float32),
            rng.standard_normal((B, T, K_, hd)).astype(np.float32))


def _jax(q, k, v, causal, scale=None):
    return np.asarray(j_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=causal,
                                      scale=scale))


def _port(q, k, v, causal, dtype=torch.float32, **kw):
    t = [torch.as_tensor(a).to(dtype) for a in (q, k, v)]
    out = flash_attention(*t, causal=causal, **kw)
    assert out.dtype == torch.float32
    return out.numpy()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_jax_f32(shape, causal):
    q, k, v = _qkv(shape, 2)
    np.testing.assert_allclose(_port(q, k, v, causal), _jax(q, k, v, causal),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_inputs_match_jax(shape, causal):
    q, k, v = _qkv(shape, 3)
    np.testing.assert_allclose(
        _port(q, k, v, causal, dtype=torch.bfloat16), _jax(q, k, v, causal),
        rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("S,T", [(100, None), (100, 37), (37, 100)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_odd_lengths(S, T, causal):
    """Lengths no block divides, and S != T (the causal mask is aligned
    at the first position in both packages)."""
    q, k, v = _qkv((2, S, 4, 2, 16), 5, T=T)
    np.testing.assert_allclose(_port(q, k, v, causal), _jax(q, k, v, causal),
                               rtol=2e-4, atol=2e-4)


def test_flash_attention_gqa_group_of_four():
    """H/K = 4: query head h reads kv head h // 4.  Each q head is also
    checked against single-head attention on its own kv head."""
    q, k, v = _qkv((2, 64, 8, 2, 32), 9)
    got = _port(q, k, v, True)
    np.testing.assert_allclose(got, _jax(q, k, v, True), rtol=2e-4,
                               atol=2e-4)
    for h in range(8):
        one = _jax(q[:, :, h:h + 1], k[:, :, h // 4:h // 4 + 1],
                   v[:, :, h // 4:h // 4 + 1], True)
        np.testing.assert_allclose(got[:, :, h:h + 1], one, rtol=2e-4,
                                   atol=2e-4)


def test_flash_attention_scale_and_impls():
    """``scale`` reaches both versions; ``impl="plain"`` is the plain
    version; an unknown impl raises."""
    q, k, v = _qkv((1, 48, 2, 1, 16), 11)
    np.testing.assert_allclose(
        _port(q, k, v, True, scale=0.3), _jax(q, k, v, True, scale=0.3),
        rtol=2e-4, atol=2e-4)
    t = [torch.as_tensor(a) for a in (q, k, v)]
    torch.testing.assert_close(flash_attention(*t, impl="plain"),
                               attention_ref(*t))
    with pytest.raises(ValueError):
        flash_attention(*t, impl="pallas")


def test_wrapper_takes_the_plain_version_only_on_cpu():
    """A CPU tensor runs the plain version and launches nothing; a
    tensor on another device is refused; bad shapes raise."""
    q, k, v = (torch.as_tensor(a) for a in _qkv((1, 16, 2, 1, 16), 1))
    before = K.flash_attention.launches
    K.flash_attention(q, k, v)
    assert K.flash_attention.launches == before
    with pytest.raises(ValueError):
        K.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError):
        K.flash_attention(q, k[:, :, :, :8], v)
    with pytest.raises(ValueError):
        K.flash_attention(q[:, :, :1].expand(1, 16, 3, 16), k, v[:, :8])


# -- the backward -------------------------------------------------------------
#
# On the CPU the op differentiates through ``FlashAttentionFn`` with the
# plain backward ``attention_bwd_ref`` (the Hopper backward kernel runs
# only on the card).  The JAX side is ``jax.grad`` of its
# ``attention_ref``; float32 throughout, so the gradients agree to 1e-5
# (summation orders only).

# (shape (B,S,H,K,hd), T or None for S, scale or None for hd^-0.5)
BWD_CASES = [((2, 48, 4, 2, 16), None, None),      # GQA 2
             ((1, 40, 8, 2, 32), None, 0.3),       # GQA 4, explicit scale
             ((2, 33, 4, 4, 16), 70, None),        # S < T
             ((1, 70, 4, 1, 16), 33, 0.2)]         # S > T, one kv head


def _do(shape, seed):
    B, S, H, _, hd = shape
    return np.random.default_rng(seed).standard_normal(
        (B, S, H, hd)).astype(np.float32)


def _jax_grads(q, k, v, do, causal, scale):
    def f(q, k, v):
        out = j_attention_ref(q, k, v, causal=causal, scale=scale)
        return jnp.sum(out * jnp.asarray(do))
    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _autograd(fn, q, k, v, do):
    t = [torch.as_tensor(a).requires_grad_() for a in (q, k, v)]
    out = fn(*t)
    return out, [g.numpy() for g in torch.autograd.grad(
        out, t, torch.as_tensor(do))]


@pytest.mark.parametrize("shape,T,scale", BWD_CASES,
                         ids=[f"{c[0]}-T{c[1]}-s{c[2]}" for c in BWD_CASES])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_fn_grads_match_jax_and_autograd(shape, T, scale,
                                                         causal):
    """The op's gradients (``FlashAttentionFn``, its backward the plain
    ``attention_bwd_ref`` on the CPU) against ``jax.grad`` of the JAX
    package's ``attention_ref`` and against PyTorch's autograd through
    the port's, 1e-5."""
    q, k, v = _qkv(shape, sum(shape), T=T)
    do = _do(shape, 1)
    out, got = _autograd(lambda *t: flash_attention(
        *t, causal=causal, scale=scale), q, k, v, do)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    _, auto = _autograd(lambda *t: attention_ref(
        *t, causal=causal, scale=scale), q, k, v, do)
    for g, a, j in zip(got, auto, _jax_grads(q, k, v, do, causal, scale)):
        np.testing.assert_allclose(g, j, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g, a, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_bwd_ref_matches_autograd(causal):
    """The explicit formulas against autograd through ``attention_ref``,
    in float64, where only rounding separates them (1e-10)."""
    shape, T = (2, 37, 4, 2, 16), 50
    q, k, v = (torch.as_tensor(a, dtype=torch.float64)
               for a in _qkv(shape, 4, T=T))
    do = torch.as_tensor(_do(shape, 5), dtype=torch.float64)
    t = [a.clone().requires_grad_() for a in (q, k, v)]
    out = attention_ref(*t, causal=causal, scale=0.3).double()
    auto = torch.autograd.grad(out, t, do)
    got = attention_bwd_ref(q.double(), k.double(), v.double(),
                            out.detach(), do, causal=causal, scale=0.3)
    for g, a in zip(got, auto):
        assert g.shape == a.shape
        np.testing.assert_allclose(g.double().numpy(), a.numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_attention_lse_ref_is_the_base2_log_sum_exp():
    """``lse`` per (b, h, s): log2 of sum_t 2^(scale log2(e) q.k_t), the
    natural log-sum-exp of the masked scaled scores times log2(e)."""
    q, k, _ = _qkv((1, 20, 4, 2, 16), 6, T=30)
    lse = attention_lse_ref(torch.as_tensor(q), torch.as_tensor(k),
                            causal=True, scale=0.25).numpy()
    assert lse.shape == (1, 4, 20)
    for h in range(4):
        s = q[0, :, h] @ k[0, :, h // 2].T * 0.25                # (S, T)
        s = np.where(np.arange(30)[None] <= np.arange(20)[:, None], s,
                     -np.inf)
        want = np.log2(np.sum(np.exp2(s * np.log2(np.e)), axis=-1))
        np.testing.assert_allclose(lse[0, h], want, rtol=1e-5, atol=1e-5)


def test_flash_attention_fwd_op_and_plain_impl_grads():
    """``torch.ops.repro_torch.flash_attention_fwd`` returns the output
    and its lse; without grad the op is the wrapper itself;
    ``impl="plain"`` differentiates by autograd."""
    q, k, v = (torch.as_tensor(a) for a in _qkv((1, 24, 4, 2, 16), 8))
    out, lse = torch.ops.repro_torch.flash_attention_fwd(q, k, v, True, 0.25)
    torch.testing.assert_close(out, attention_ref(q, k, v, scale=0.25))
    torch.testing.assert_close(lse, attention_lse_ref(q, k, scale=0.25))
    assert O.flash_attention(q, k, v).grad_fn is None
    qg = q.clone().requires_grad_()
    plain = O.flash_attention(qg, k, v, impl="plain")
    assert type(plain.grad_fn).__name__ != "FlashAttentionFnBackward"
    with torch.no_grad():
        assert O.flash_attention(qg, k, v).grad_fn is None
