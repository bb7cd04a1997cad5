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
package's kernel tests draw them.  The backward kernel runs its four
per-head products (B.dstate^T, (w o x).dstate, dy.x^T and M^T.dy) on the
tensor cores as 3xTF32; that arithmetic is emulated here and held to the
card tests' gate, and the card tests hold the kernel itself against the
plain version.
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


# The kernel's arithmetic.  Each of the four per-head products runs as
# 3xTF32: each operand a splits into big = tf32(a) and small = tf32(a -
# big), rounded to nearest with ties away from zero, and a.b is summed in
# float32 as small.big + big.small + big.big.  The per-chunk products
# (C.B^T, dCB.B, dCB^T.C) and everything elementwise stay float32.

# the shapes of the card test of the backward kernel (B, c, Q, H, P, N)
CARD_SHAPES = [(1, 4, 8, 2, 8, 8), (2, 3, 17, 3, 32, 16),
               (1, 2, 100, 9, 64, 64), (2, 1, 256, 5, 64, 128),
               (1, 1, 1, 2, 8, 8), (1, 2, 193, 17, 16, 128),
               (1, 3, 37, 3, 32, 12), (2, 1, 64, 11, 8, 4),
               (1, 1, 193, 3, 8, 4), (1, 1, 256, 9, 64, 64),
               (1, 2, 256, 3, 64, 128), (1, 2, 70, 3, 16, 196)]
# per gradient, the dims of the slice whose largest |plain| scales its
# error (dx, ddt per (b, c, h); dB, dC per (b, c)); dA's scale is
# ssd_dA_scale
SLICES = {"dx": (2, 4), "ddt": (2,), "dB": (2, 3), "dC": (2, 3)}


def _tf32(a):
    """float32 -> TF32 (10 mantissa bits), to nearest, ties away from
    zero: cvt.rna.tf32.f32 on the int32 view, as the kernel does it."""
    i = a.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm3(a, b):
    """a @ b from three TF32 products of the split operands."""
    ab, bb = _tf32(a), _tf32(b)
    as_, bs = _tf32(a - ab), _tf32(b - bb)
    return as_ @ bb + ab @ bs + ab @ bb


def _mm1(a, b):
    """a @ b from one TF32 product: the contrast."""
    return _tf32(a) @ _tf32(b)


def _ssd_bwd_emulated(x, dt, A, Bm, Cm, dy, dstate, ddecay, mm=_mm3):
    """``ref._bwd``'s formulas with the kernel's four per-head products
    through ``mm``: U = B.dstate^T, the state term of dB as one product
    over (h, p) of w o x and dstate, dM = dy.x^T and dx's M^T.dy; exp is
    taken only where j <= i (exp of 0 elsewhere)."""
    Bsz, c, Q, H, P = x.shape
    N = Bm.shape[-1]
    acum = torch.cumsum(dt * A, dim=2)                     # (B,c,Q,H)
    CB = Cm @ Bm.transpose(-1, -2)                         # (B,c,i,j)
    ar = torch.arange(Q)
    mask = (ar[:, None] >= ar[None, :])[..., None]         # (i,j,1)
    diff = acum[..., :, None, :] - acum[..., None, :, :]   # (B,c,i,j,H)
    L = torch.where(mask, torch.exp(torch.where(mask, diff, 0.0)), 0.0)
    dtj = dt[:, :, None, :, :]                             # (B,c,1,j,H)
    M = CB[..., None] * L * dtj
    xh = x.permute(0, 1, 3, 2, 4)                          # (B,c,H,Q,P)
    dyh = dy.permute(0, 1, 3, 2, 4)
    dM = mm(dyh, xh.transpose(-1, -2)).permute(0, 1, 3, 4, 2)  # (B,c,i,j,H)
    G = dM * L
    dte = torch.exp(acum[:, :, -1:, :] - acum)
    w = dt * dte
    U = mm(Bm[:, :, None], dstate.transpose(-1, -2))       # (B,c,H,Q,P)
    U = U.permute(0, 1, 3, 2, 4)                           # (B,c,Q,H,P)
    Mt = M.permute(0, 1, 4, 3, 2)                          # (B,c,H,j,i)
    dx = (w[..., None] * U
          + mm(Mt, dyh).permute(0, 1, 3, 2, 4))
    dCB = (G * dtj).sum(-1)
    dC = dCB @ Bm
    wx = (w[..., None] * x).reshape(Bsz, c, Q, H * P)
    dB = dCB.transpose(-1, -2) @ Cm + mm(wx, dstate.reshape(Bsz, c, H * P,
                                                             N))
    dw = (x * U).sum(-1)
    GCB = G * CB[..., None]
    R = GCB * dtj
    dacum = R.sum(3) - R.sum(2) - dw * w
    last = (dw * w).sum(2) + ddecay * torch.exp(acum[:, :, -1, :])
    dacum = torch.cat([dacum[:, :, :-1], dacum[:, :, -1:] + last[:, :, None]],
                      dim=2)
    da = torch.flip(torch.cumsum(torch.flip(dacum, (2,)), 2), (2,))
    ddt = GCB.sum(2) + dw * dte + A * da
    dA = (da * dt).sum((0, 1, 2))
    return dx, ddt, dA, dB, dC


def _gate_shares(ins, cots, mm=_mm3):
    """Each gradient's largest error as a share of its scale (the card
    gate passes at <= 1e-4), and the emulated gradients."""
    got = _ssd_bwd_emulated(*ins, *cots, mm=mm)
    want = ssd_chunk_bwd_ref(*ins, *cots)
    dA_scale = ssd_dA_scale(*ins, *cots)
    shares = {}
    for name, g, w in zip(NAMES, got, want):
        assert bool(torch.isfinite(g).all()), name
        scale = (w.abs().amax(dim=SLICES[name], keepdim=True)
                 if name in SLICES else dA_scale).clamp_min(1e-30)
        shares[name] = float(((g - w).abs() / scale).max())
    return shares, got


@pytest.mark.parametrize("B,c,Q,H,P,N", CARD_SHAPES)
def test_3xtf32_emulation_holds_the_card_gate(B, c, Q, H, P, N):
    """The backward kernel's 3xTF32 arithmetic against the plain version
    at the card test's shapes (its draws, numpy cotangents on y, state
    and decay), under the card's gate: dx and ddt within 1e-4 of their
    (b, c, h) slice's largest |plain|, dB and dC of their (b, c) slice's,
    dA of the sum of its terms' magnitudes."""
    lead = (B, c, Q)
    ins = _t(*_inputs(lead, H, P, N, seed=B + c + Q + H))
    cots = _t(*_cotangents(lead, H, P, N, seed=Q))
    shares, _ = _gate_shares(ins, cots)
    assert max(shares.values()) <= 1e-4, shares


def test_3xtf32_emulation_steep_decay():
    """dt near 0.1 and A near -16 at Q 256: acum falls by ~1.6 a row, so
    exp above the diagonal would overflow; the emulated kernel stays
    finite and within the card gate."""
    rng = np.random.default_rng(7)
    f = np.float32
    lead, H, P, N = (1, 2, 256), 3, 64, 128
    x = rng.standard_normal(lead + (H, P)).astype(f)
    dt = rng.uniform(0.09, 0.11, lead + (H,)).astype(f)
    A = (-rng.uniform(15.0, 16.0, H)).astype(f)
    Bm = rng.standard_normal(lead + (N,)).astype(f)
    Cm = rng.standard_normal(lead + (N,)).astype(f)
    cots = _t(*_cotangents(lead, H, P, N, seed=7))
    shares, _ = _gate_shares(_t(x, dt, A, Bm, Cm), cots)
    assert max(shares.values()) <= 1e-4, shares


def test_single_tf32_misses_the_card_gate():
    """The contrast: one TF32 product per k-step (tf32(a).tf32(b)), at the
    path's P and N, misses the gate that 3xTF32 holds."""
    B, c, Q, H, P, N = 2, 1, 256, 5, 64, 128
    lead = (B, c, Q)
    ins = _t(*_inputs(lead, H, P, N, seed=B + c + Q + H))
    cots = _t(*_cotangents(lead, H, P, N, seed=Q))
    three, _ = _gate_shares(ins, cots)
    one, _ = _gate_shares(ins, cots, mm=_mm1)
    assert max(three.values()) <= 1e-4 < max(one.values()), (three, one)
