"""The backward of the port's SSD intra-chunk step against the JAX
package, on the CPU.

``ssd_chunk_bwd_ref`` (the backward kernel's plain version: explicit
formulas, float32) against ``jax.vjp`` of the JAX package's
``ssd_chunk_ref``, chunk by chunk, with cotangents on y, the chunk state
and the chunk decay (rel L2 <= 1e-5: float32 throughout, the sums taken
in other orders), and against torch autograd of ``ssd_chunk_batched_ref``.
Then the chunked op under grad, which on the kernel route goes through
``SSDChunkFn`` (on CPU tensors its forward and backward are the plain
versions), against ``jax.grad`` of the JAX package's
``models.ssm.ssd_chunked`` with a carried-in state and an S that needs
padding (1e-4).  Inputs come from numpy with a seed, drawn as the JAX
package's kernel tests draw them.  The backward kernel runs its products
as float32 FMA, so there is no reduced-precision arithmetic to emulate
here; the card tests hold it against the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd.ref import ssd_chunk_ref as j_chunk_ref
from repro.models import ssm as j_ssm
from repro_torch.kernels.ssd import kernel as K
from repro_torch.kernels.ssd import ops as O
from repro_torch.kernels.ssd.ref import (ssd_chunk_batched_ref,
                                         ssd_chunk_bwd_ref, ssd_dA_scale)
from repro_torch.models import ssm as t_ssm

torch.set_num_threads(1)

NAMES = ("dx", "ddt", "dA", "dB", "dC")


def _inputs(lead, H, P, N, seed, init=False):
    """x lead+(H,P), dt lead+(H,), A (H,), B and C lead+(N,), float32.
    With ``init`` dt and A come from Mamba-2's published initialisation
    (dt log-uniform on [1e-3, 0.1], A uniform on [-16, -1])."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal(lead + (H, P)).astype(f)
    if init:
        dt = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), lead + (H,)))
        A = -rng.uniform(1.0, 16.0, H)
    else:
        dt = np.log1p(np.exp(rng.standard_normal(lead + (H,))))
        A = -np.exp(rng.standard_normal(H))
    dt, A = dt.astype(f), A.astype(f)
    Bm = rng.standard_normal(lead + (N,)).astype(f)
    Cm = rng.standard_normal(lead + (N,)).astype(f)
    return x, dt, A, Bm, Cm


def _cotangents(lead, H, P, N, seed):
    """dy lead+(H,P), dstate lead[:-1]+(H,P,N), ddecay lead[:-1]+(H,)."""
    rng = np.random.default_rng(seed + 1000)
    f = np.float32
    return (rng.standard_normal(lead + (H, P)).astype(f),
            rng.standard_normal(lead[:-1] + (H, P, N)).astype(f),
            rng.standard_normal(lead[:-1] + (H,)).astype(f))


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _jax_chunk_vjp(ins, cots):
    """jax.vjp of the JAX package's one-chunk reference, chunk by chunk
    over (b, c); dA summed over the chunks."""
    x, dt, A, Bm, Cm = ins
    dy, dstate, ddecay = cots
    B, c = x.shape[:2]
    out = [np.zeros_like(x), np.zeros_like(dt), np.zeros(A.shape, np.float64),
           np.zeros_like(Bm), np.zeros_like(Cm)]
    for b in range(B):
        for k in range(c):
            _, vjp = jax.vjp(j_chunk_ref, x[b, k], dt[b, k], A, Bm[b, k],
                             Cm[b, k])
            gx, gdt, gA, gB, gC = vjp((jnp.asarray(dy[b, k]),
                                       jnp.asarray(dstate[b, k]),
                                       jnp.asarray(ddecay[b, k])))
            out[0][b, k], out[1][b, k] = gx, gdt
            out[2] += np.asarray(gA, np.float64)
            out[3][b, k], out[4][b, k] = gB, gC
    return out


@pytest.mark.parametrize("Q", [1, 17, 64])
@pytest.mark.parametrize("H", [1, 3])
@pytest.mark.parametrize("P,N", [(8, 4), (8, 16), (16, 4), (16, 16)])
def test_bwd_ref_matches_jax_vjp(Q, H, P, N):
    """Every gradient of the chunk step, cotangents on y, state and
    decay, against ``jax.vjp`` of ``ssd_chunk_ref`` (rel L2 <= 1e-5).
    dA is a sum over chunks and rows whose terms cancel, so its error is
    taken relative to the sum of the terms' magnitudes
    (``ssd_dA_scale``): at Q 17, H 1, P 8, N 4 the JAX package's float32
    dA is 1.7e-5 of |dA| from the float64 value, the port's 2.4e-6.
    At Q 64 the decays are Mamba-2's init: with the kernel tests' draws
    the reference's own gradient is NaN there (the test below)."""
    lead = (1, 2, Q)
    ins = _inputs(lead, H, P, N, seed=Q * 100 + H * 10 + P + N,
                  init=Q > 32)
    cots = _cotangents(lead, H, P, N, seed=Q + H + P + N)
    got = ssd_chunk_bwd_ref(*_t(*ins), *_t(*cots))
    want = _jax_chunk_vjp(ins, cots)
    scale = ssd_dA_scale(*_t(*ins), *_t(*cots)).numpy()
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32
        assert tuple(g.shape) == w.shape, name
        if name == "dA":
            assert (np.linalg.norm(g.numpy() - w)
                    <= 1e-5 * np.linalg.norm(scale)), name
        else:
            assert _rel_l2(g.numpy(), w) <= 1e-5, name


@pytest.mark.parametrize("lead,H,P,N", [((2, 3, 17), 3, 8, 4),
                                        ((1, 2, 64), 2, 16, 16),
                                        ((2, 1, 1), 4, 8, 8),
                                        ((1, 2, 100), 5, 32, 12)])
def test_bwd_ref_matches_torch_autograd(lead, H, P, N):
    """The explicit formulas against torch autograd of the batched
    forward, float32 (rel L2 <= 1e-5)."""
    ins = [t.requires_grad_() for t in _t(*_inputs(lead, H, P, N, seed=9))]
    cots = _t(*_cotangents(lead, H, P, N, seed=9))
    want = torch.autograd.grad(ssd_chunk_batched_ref(*ins), ins, cots)
    got = ssd_chunk_bwd_ref(*(t.detach() for t in ins), *cots)
    for name, g, w in zip(NAMES, got, want):
        assert _rel_l2(g.numpy(), w.numpy()) <= 1e-5, name


def test_bwd_stays_finite_where_the_reference_overflows():
    """With the kernel tests' draws at Q 64 some chunk's decay passes
    exp(-88): the JAX package's reference, which masks exp(acum_i -
    acum_j) after taking it, gives NaN gradients (inf * 0), and the
    port's plain version, which takes exp of 0 above the diagonal, gives
    finite ones, equal to its own autograd."""
    lead, H, P, N = (1, 2, 64), 3, 8, 4
    ins = _inputs(lead, H, P, N, seed=64 * 100 + 3 * 10 + 8 + 4)
    cots = _cotangents(lead, H, P, N, seed=64 + 3 + 8 + 4)
    want = _jax_chunk_vjp(ins, cots)
    assert any(np.isnan(w).any() for w in want)
    leaves = [t.requires_grad_() for t in _t(*ins)]
    auto = torch.autograd.grad(ssd_chunk_batched_ref(*leaves), leaves,
                               _t(*cots))
    for name, g, a in zip(NAMES, ssd_chunk_bwd_ref(*_t(*ins), *_t(*cots)),
                          auto):
        assert bool(torch.isfinite(g).all()), name
        assert _rel_l2(g.numpy(), a.numpy()) <= 1e-5, name


def test_bwd_none_cotangents_count_as_zeros():
    """A cotangent given as None counts as zeros, in the plain version
    and in the wrapper on CPU tensors."""
    lead, H, P, N = (1, 2, 24), 3, 8, 8
    ins = _t(*_inputs(lead, H, P, N, seed=5))
    dy, dstate, ddecay = _t(*_cotangents(lead, H, P, N, seed=5))
    for keep in ((dy, None, None), (None, dstate, None),
                 (None, None, ddecay), (dy, None, ddecay)):
        zeros = [torch.zeros_like(t) if k is None else k
                 for k, t in zip(keep, (dy, dstate, ddecay))]
        want = ssd_chunk_bwd_ref(*ins, *zeros)
        for got in (ssd_chunk_bwd_ref(*ins, *keep),
                    K.ssd_chunk_bwd(*ins, *keep)):
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=0, atol=0)
    for g in ssd_chunk_bwd_ref(*ins):
        assert not bool(g.any())


def test_bwd_wrapper_checks_cotangent_shapes():
    lead, H, P, N = (1, 2, 16), 2, 8, 8
    ins = _t(*_inputs(lead, H, P, N, seed=6))
    dy, dstate, ddecay = _t(*_cotangents(lead, H, P, N, seed=6))
    with pytest.raises(ValueError, match="dy"):
        K.ssd_chunk_bwd(*ins, dy[..., :4], dstate, ddecay)
    with pytest.raises(ValueError, match="dstate"):
        K.ssd_chunk_bwd(*ins, dy, dstate[..., :4], ddecay)
    with pytest.raises(ValueError, match="ddecay"):
        K.ssd_chunk_bwd(*ins, dy, dstate, ddecay[..., :1])
    with pytest.raises(ValueError, match="bad shapes"):
        K.ssd_chunk_bwd(ins[0], ins[1][..., :1], *ins[2:], dy, dstate, ddecay)


def test_dA_scale_bounds_dA():
    """The scale dA's error is held against on the card is the sum of
    its terms' magnitudes: never below |dA|."""
    lead, H, P, N = (2, 3, 32), 4, 8, 8
    ins = _t(*_inputs(lead, H, P, N, seed=8))
    cots = _t(*_cotangents(lead, H, P, N, seed=8))
    dA = ssd_chunk_bwd_ref(*ins, *cots)[2]
    scale = ssd_dA_scale(*ins, *cots)
    assert tuple(scale.shape) == (H,)
    assert bool((scale >= dA.abs() * (1 - 1e-6)).all())


class _Counted:
    """``kernel.ssd_chunk_bwd`` with a count of its calls."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **k):
        self.calls += 1
        return self.fn(*a, **k)


@pytest.mark.parametrize("S,chunk", [(40, 16), (27, 8), (64, 16)])
def test_chunked_op_grad_matches_jax(monkeypatch, S, chunk):
    """The model's ``ssd_chunked`` on the kernel route under grad, with a
    carried-in state and S padded to the chunk: the gradients of a loss
    on y and the final state go through ``SSDChunkFn`` (its backward
    called once) and match ``jax.grad`` of the JAX package's
    ``models.ssm.ssd_chunked`` (rel L2 <= 1e-4)."""
    B, H, P, N = 2, 3, 8, 16
    ins = _inputs((B, S), H, P, N, seed=S + chunk)
    rng = np.random.default_rng(S)
    h0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    wy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    wh = rng.standard_normal((B, H, P, N)).astype(np.float32)

    def j_loss(x, dt, A, Bm, Cm, h0):
        y, h = j_ssm.ssd_chunked(x, dt, A, Bm, Cm, chunk, h0=h0)
        return jnp.sum(y * wy) + jnp.sum(h * wh)

    want = jax.grad(j_loss, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in ins), jnp.asarray(h0))
    counted = _Counted(K.ssd_chunk_bwd)
    monkeypatch.setattr(K, "ssd_chunk_bwd", counted)
    leaves = [t.requires_grad_() for t in _t(*ins, h0)]
    y, h = t_ssm.ssd_chunked(*leaves[:5], chunk, h0=leaves[5])
    loss = (y * torch.as_tensor(wy)).sum() + (h * torch.as_tensor(wh)).sum()
    got = torch.autograd.grad(loss, leaves)
    assert counted.calls == 1
    for name, g, w in zip(NAMES + ("dh0",), got, want):
        assert _rel_l2(g.numpy(), w) <= 1e-4, name


def test_chunked_op_grad_kernel_route_equals_plain_autograd():
    """On CPU tensors the Function's route and plain autograd through
    the plain version agree (rel L2 <= 1e-5)."""
    B, S, H, P, N = 2, 48, 4, 16, 8
    ins = _inputs((B, S), H, P, N, seed=12)
    grads = {}
    for impl in O.IMPLS:
        leaves = [t.requires_grad_() for t in _t(*ins)]
        y, h = O.ssd_chunked(*leaves, 16, impl=impl)
        grads[impl] = torch.autograd.grad(y.square().sum() + h.sum(), leaves)
    for name, g, w in zip(NAMES, grads["kernel"], grads["plain"]):
        assert _rel_l2(g.numpy(), w.numpy()) <= 1e-5, name


def test_bf16_inputs_get_bf16_grads():
    """``SSDChunkFn`` computes in float32 and returns each input's
    gradient in that input's dtype."""
    lead, H, P, N = (1, 2, 16), 2, 8, 8
    ins = [t.to(torch.bfloat16).requires_grad_()
           for t in _t(*_inputs(lead, H, P, N, seed=3))]
    y, state, decay = O.SSDChunkFn.apply(*ins)
    assert y.dtype == state.dtype == decay.dtype == torch.float32
    grads = torch.autograd.grad(y.sum() + state.sum() + decay.sum(), ins)
    want = ssd_chunk_bwd_ref(*(t.detach() for t in ins),
                             torch.ones_like(y), torch.ones_like(state),
                             torch.ones_like(decay))
    for name, g, t, w in zip(NAMES, grads, ins, want):
        assert g.dtype == torch.bfloat16, name
        torch.testing.assert_close(g, w.to(torch.bfloat16), rtol=0, atol=0)


def test_function_unused_outputs_pass_none():
    """A loss on y alone reaches the backward with None for the state's
    and the decay's cotangents, which count as zeros."""
    lead, H, P, N = (1, 2, 16), 2, 8, 8
    ins = [t.requires_grad_() for t in _t(*_inputs(lead, H, P, N, seed=4))]
    y, _, _ = O.SSDChunkFn.apply(*ins)
    got = torch.autograd.grad(y.sum(), ins)
    want = ssd_chunk_bwd_ref(*(t.detach() for t in ins), torch.ones_like(y))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_function_hands_the_backward_contiguous_float32_cotangents(
        monkeypatch):
    """Autograd hands ``y.sum()``'s cotangent over with stride 0 (and a
    bf16 loss's in bf16); the card kernel takes contiguous float32, so
    the Function makes every cotangent so before the backward sees it."""
    seen, bwd = [], K.ssd_chunk_bwd

    def checked(*args):
        seen.append(args[5:])
        return bwd(*args)
    monkeypatch.setattr(O._kernel, "ssd_chunk_bwd", checked)
    B, S, H, P, N = 1, 32, 2, 8, 4
    leaves = [t.requires_grad_() for t in _t(*_inputs((B, S), H, P, N,
                                                      seed=5))]
    y, h = O.ssd_chunked(*leaves, 16)
    got = torch.autograd.grad(y.sum() + h.to(torch.bfloat16).sum(), leaves)
    assert len(seen) == 1
    cots = [g for g in seen[0] if g is not None]
    assert cots and all(g.is_contiguous() and g.dtype == torch.float32
                        for g in cots)
    assert all(bool(torch.isfinite(g).all()) for g in got)
