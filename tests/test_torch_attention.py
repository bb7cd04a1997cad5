"""The port's flash-attention op against the JAX package, on the CPU.

On CPU tensors the op runs its plain PyTorch version (the Hopper kernel
runs only on the card: ``tests/test_torch_cuda_kernels.py``).  Inputs are
made with numpy from a seed and handed to both packages.  The JAX side
is ``attention_ref``: the Pallas wrapper ``flash_attention_pallas`` does
not run on the installed jax (ROADMAP.md, Queue 3).  Tolerances are the
JAX package's own flash-attention ones (``tests/test_kernels.py``):
2e-4 for float32 inputs, 5e-2 for bf16 inputs against float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention.ref import attention_ref as j_attention_ref
from repro_torch.kernels.attention import flash_attention
from repro_torch.kernels.attention import kernel as K
from repro_torch.kernels.attention.ref import attention_ref

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
