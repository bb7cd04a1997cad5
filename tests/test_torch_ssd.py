"""The port's SSD intra-chunk step and chunked op against the JAX
package, on the CPU.

Inputs come from numpy with a seed, drawn as the JAX package's kernel
tests draw them (normal x, B and C; softplus-normal dt; A = -exp(normal))
and go through the JAX function and its port.  On CPU tensors the
port's ``ssd_chunk`` wrapper runs its plain version; the JAX side runs
its reference, its plain chunked form and its Pallas kernel in interpret
mode.  Tolerance 1e-4 (rtol and atol): float32 throughout, the products
and cumsums summed in other orders by XLA and PyTorch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd.kernel import ssd_chunk_pallas
from repro.kernels.ssd.ops import ssd_chunked_pallas
from repro.kernels.ssd.ref import ssd_chunk_ref as j_chunk_ref
from repro.models import ssm as j_ssm
from repro_torch.kernels.ssd import kernel as K
from repro_torch.kernels.ssd import ops as O
from repro_torch.kernels.ssd.ref import ssd_chunk_batched_ref, ssd_chunk_ref
from repro_torch.models import ssm as t_ssm

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)


def _softplus(v):
    return np.log1p(np.exp(v))


def _inputs(lead, H, P, N, seed):
    """x lead+(H,P), dt lead+(H,), A (H,), B and C lead+(N,), float32."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal(lead + (H, P)).astype(f)
    dt = _softplus(rng.standard_normal(lead + (H,))).astype(f)
    A = (-np.exp(rng.standard_normal(H))).astype(f)
    Bm = rng.standard_normal(lead + (N,)).astype(f)
    Cm = rng.standard_normal(lead + (N,)).astype(f)
    return x, dt, A, Bm, Cm


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


# -- the chunk step ----------------------------------------------------------

@pytest.mark.parametrize("Q,H,P,N", [(8, 2, 8, 8), (16, 4, 16, 16),
                                     (32, 2, 32, 32), (13, 3, 64, 128),
                                     (1, 2, 8, 8)])
def test_chunk_ref_matches_jax(Q, H, P, N):
    ins = _inputs((Q,), H, P, N, seed=Q + H)
    for g, w in zip(ssd_chunk_ref(*_t(*ins)), j_chunk_ref(*_j(*ins))):
        _close(g.numpy(), w)


@pytest.mark.parametrize("B,c,Q,H,P,N", [(1, 4, 8, 2, 8, 8),
                                         (2, 2, 16, 4, 16, 16),
                                         (2, 3, 32, 2, 32, 32),
                                         (1, 2, 13, 3, 64, 64)])
def test_chunk_batched_matches_pallas_interpret(B, c, Q, H, P, N):
    """The plain batched form and the wrapper on CPU tensors against the
    Pallas kernel run in interpret mode and against the per-chunk
    references."""
    ins = _inputs((B, c, Q), H, P, N, seed=B * c * Q)
    x, dt, A, Bm, Cm = ins
    want = ssd_chunk_pallas(*_j(*ins), interpret=True)
    before = K.ssd_chunk.launches
    for got in (ssd_chunk_batched_ref(*_t(*ins)), K.ssd_chunk(*_t(*ins))):
        assert [tuple(g.shape) for g in got] == [
            (B, c, Q, H, P), (B, c, H, P, N), (B, c, H)]
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            _close(g.numpy(), w)
    assert K.ssd_chunk.launches == before     # CPU tensors launch nothing
    y1, s1, d1 = j_chunk_ref(x[0, 1], dt[0, 1], A, Bm[0, 1], Cm[0, 1])
    _close(want[0][0, 1], y1)
    _close(want[1][0, 1], s1)
    _close(want[2][0, 1], d1)


def test_chunk_takes_bf16_as_float32():
    ins = _inputs((1, 2, 16), 2, 16, 16, seed=5)
    t32 = _t(*ins)
    tb = [t.bfloat16() for t in t32]
    got = K.ssd_chunk(*tb)
    want = ssd_chunk_batched_ref(*[t.float() for t in tb])
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_chunk_wrapper_checks_shapes():
    x, dt, A, Bm, Cm = _t(*_inputs((1, 2, 8), 2, 8, 8, seed=1))
    with pytest.raises(ValueError):
        K.ssd_chunk(x[0], dt, A, Bm, Cm)
    with pytest.raises(ValueError):
        K.ssd_chunk(x, dt[..., :1], A, Bm, Cm)
    with pytest.raises(ValueError):
        K.ssd_chunk(x, dt, A, Bm, Cm[..., :4])
    with pytest.raises(ValueError):
        K.ssd_chunk(x, dt, A[:1], Bm, Cm)


# -- the chunked op ----------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 32, 2, 8, 8), (2, 64, 4, 8, 16),
                                   (2, 128, 2, 16, 32)])
@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_chunked_op_matches_jax(shape, chunk):
    """The shapes and chunks of the JAX package's SSD kernel test: the
    port's op (the wrapper's plain version on CPU tensors) against the
    sequential reference, the plain chunked form and the Pallas op."""
    B, S, H, P, N = shape
    ins = _inputs((B, S), H, P, N, seed=sum(shape) + chunk)
    y, h = O.ssd_chunked(*_t(*ins), chunk=chunk)
    jins = _j(*ins)
    for wy, wh in (j_ssm.ssd_reference(*jins),
                   j_ssm.ssd_chunked(*jins, chunk),
                   ssd_chunked_pallas(*jins, chunk=chunk, interpret=True)):
        _close(y.numpy(), wy)
        _close(h.numpy(), wh)
    ty, th = t_ssm.ssd_reference(*_t(*ins))
    _close(ty.numpy(), y.numpy())
    _close(th.numpy(), h.numpy())



def test_reference_op_name_and_keywords_run_on_the_port():
    """``ssd_chunked_pallas(x, dt, A, Bm, Cm, chunk, *, h0, interpret)``,
    the JAX package's public op, is the port's op on its default route
    (the plain version on CPU tensors, no launch) and matches the JAX
    op called the same way, with and without a carried state."""
    ins = _inputs((2, 32), 2, 8, 8, seed=4)
    h0 = np.random.default_rng(5).standard_normal(
        (2, 2, 8, 8)).astype(np.float32)
    before = K.ssd_chunk.launches
    for carry in (None, h0):
        t_h0 = None if carry is None else torch.as_tensor(carry)
        y, h = O.ssd_chunked_pallas(*_t(*ins), 8, h0=t_h0, interpret=True)
        wy, wh = O.ssd_chunked(*_t(*ins), 8, h0=t_h0)
        assert torch.equal(y, wy) and torch.equal(h, wh)
        jy, jh = ssd_chunked_pallas(
            *_j(*ins), 8, h0=None if carry is None else jnp.asarray(carry),
            interpret=True)
        _close(y.numpy(), jy)
        _close(h.numpy(), jh)
    assert K.ssd_chunk.launches == before

@pytest.mark.parametrize("S,chunk", [(27, 8), (5, 16), (1, 8), (40, 16)])
def test_ssd_chunked_pads_like_jax(S, chunk):
    """S % Q != 0, S < chunk and S = 1: the model's ``ssd_chunked`` pads
    with dt = 0 (an inert tail), as the JAX package's does."""
    ins = _inputs((2, S), 3, 8, 16, seed=S * chunk)
    y, h = t_ssm.ssd_chunked(*_t(*ins), chunk)
    assert tuple(y.shape) == (2, S, 3, 8)
    jins = _j(*ins)
    for wy, wh in (j_ssm.ssd_chunked(*jins, chunk),
                   j_ssm.ssd_reference(*jins)):
        _close(y.numpy(), wy)
        _close(h.numpy(), wh)
    yp, hp = t_ssm.ssd_chunked(*_t(*ins), chunk, impl="plain")
    torch.testing.assert_close(yp, y, rtol=0, atol=0)
    torch.testing.assert_close(hp, h, rtol=0, atol=0)


def test_state_carry_matches_jax():
    """Chunked-with-h0 continues a previous segment exactly (the JAX
    package's ``test_ssd_kernel_state_carry``)."""
    B, S, H, P, N = 1, 64, 2, 8, 16
    ins = _inputs((B, S), H, P, N, seed=11)
    x, dt, A, Bm, Cm = _t(*ins)
    y_full, h_full = O.ssd_chunked(x, dt, A, Bm, Cm, chunk=16)
    y1, h1 = O.ssd_chunked(x[:, :32], dt[:, :32], A, Bm[:, :32],
                           Cm[:, :32], chunk=16)
    y2, h2 = O.ssd_chunked(x[:, 32:], dt[:, 32:], A, Bm[:, 32:],
                           Cm[:, 32:], chunk=16, h0=h1)
    _close(torch.cat([y1, y2], 1).numpy(), y_full.numpy())
    _close(h2.numpy(), h_full.numpy())
    jx, jdt, jA, jB, jC = _j(*ins)
    _, jh1 = ssd_chunked_pallas(jx[:, :32], jdt[:, :32], jA, jB[:, :32],
                                jC[:, :32], chunk=16, interpret=True)
    jy2, jh2 = ssd_chunked_pallas(jx[:, 32:], jdt[:, 32:], jA, jB[:, 32:],
                                  jC[:, 32:], chunk=16, h0=jh1,
                                  interpret=True)
    _close(y2.numpy(), jy2)
    _close(h2.numpy(), jh2)
    # the model's form carries h0 through its padding too
    y3, h3 = t_ssm.ssd_chunked(x[:, 32:61], dt[:, 32:61], A, Bm[:, 32:61],
                               Cm[:, 32:61], 16, h0=h1)
    jy3, jh3 = j_ssm.ssd_chunked(jx[:, 32:61], jdt[:, 32:61], jA,
                                 jB[:, 32:61], jC[:, 32:61], 16,
                                 h0=jnp.asarray(h1.numpy()))
    _close(y3.numpy(), jy3)
    _close(h3.numpy(), jh3)


def test_op_checks_its_arguments():
    x, dt, A, Bm, Cm = _t(*_inputs((1, 24), 2, 8, 8, seed=2))
    with pytest.raises(ValueError, match="impl"):
        O.ssd_chunked(x, dt, A, Bm, Cm, 8, impl="pallas")
    with pytest.raises(ValueError, match="multiple"):
        O.ssd_chunked(x, dt, A, Bm, Cm, 16)
    yk, hk = O.ssd_chunked(x, dt, A, Bm, Cm, 8, impl="kernel")
    yp, hp = O.ssd_chunked(x, dt, A, Bm, Cm, 8, impl="plain")
    torch.testing.assert_close(yk, yp, rtol=0, atol=0)
    torch.testing.assert_close(hk, hp, rtol=0, atol=0)


# -- the kernel's precision scheme, emulated ---------------------------------
#
# The CUDA kernel runs its three products (C.B^T, W.x and the chunk
# states) on the tensor cores as 3xTF32: each operand a splits into
# big = tf32(a) and small = tf32(a - big), rounded to nearest with ties
# away from zero, and a.b is accumulated in float32 as
# small.big + big.small + big.big.  The kernel itself runs only on the
# card; these tests hold its arithmetic, emulated here, to the card
# tests' element-wise gate, and show that a bf16 split with three
# products would not hold it.

# the shapes of the card test of the chunk kernel (B, c, Q, H, P, N)
CARD_SHAPES = [(1, 4, 8, 2, 8, 8), (2, 4, 16, 4, 8, 16), (2, 4, 32, 2, 16, 32),
               (2, 3, 37, 3, 32, 16), (1, 2, 100, 9, 64, 64),
               (2, 1, 256, 5, 64, 128), (1, 1, 1, 2, 8, 8),
               (1, 2, 193, 17, 16, 128), (1, 3, 37, 3, 32, 12),
               (2, 1, 193, 11, 64, 20)]


def _tf32(a):
    """float32 -> TF32 (10 mantissa bits), to nearest, ties away from
    zero: cvt.rna.tf32.f32 on the int32 view, as the kernel does it."""
    i = a.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_tf32(a):
    big = _tf32(a)
    return big, _tf32(a - big)


def _split_bf16(a):
    big = a.bfloat16().float()
    return big, (a - big).bfloat16().float()


def _mm3(a, b, split):
    """a @ b from three products of split operands, float32 sums."""
    ab, as_ = split(a)
    bb, bs = split(b)
    return as_ @ bb + ab @ bs + ab @ bb


def _ssd_emulated(x, dt, A, Bm, Cm, split=_split_tf32):
    """The chunk step as the kernel computes it: scores S = C.B^T, then
    W = S * exp(acum_i - acum_j) * dt_j where j <= i (exp evaluated only
    there, exactly 0 elsewhere) against x, and the states X^T.B with
    X = x (dt exp(acum_last - acum)), every product through ``split``."""
    Q = x.shape[2]
    acum = torch.cumsum(dt * A, dim=2)                           # (B,c,Q,H)
    S = _mm3(Cm, Bm.transpose(-1, -2), split)                    # (B,c,i,j)
    ar = torch.arange(Q)
    mask = (ar[:, None] >= ar[None, :])[..., None]               # (i,j,1)
    diff = acum[:, :, :, None, :] - acum[:, :, None, :, :]       # (B,c,i,j,H)
    W = torch.where(mask, S[..., None] * torch.exp(
        torch.where(mask, diff, 0.0)) * dt[:, :, None], 0.0)
    y = _mm3(W.permute(0, 1, 4, 2, 3), x.permute(0, 1, 3, 2, 4),
             split).permute(0, 1, 3, 2, 4)
    xh = x * (dt * torch.exp(acum[:, :, -1:, :] - acum))[..., None]
    state = _mm3(xh.permute(0, 1, 3, 4, 2), Bm[:, :, None], split)
    return y, state, torch.exp(acum[:, :, -1, :])


@pytest.mark.parametrize("B,c,Q,H,P,N", CARD_SHAPES)
def test_3xtf32_emulation_holds_the_card_gate(B, c, Q, H, P, N):
    """The kernel's 3xTF32 arithmetic against the plain version at the
    card test's shapes and gate (rtol = atol = 1e-4, element by element),
    and against the Pallas kernel in interpret mode.  At Q 193-256 with
    N 128 the float32 plain version and the Pallas kernel differ from
    each other by up to 2.5x that gate (the cumsum and the products
    summed in other orders by PyTorch and XLA), so against Pallas the
    emulation is held to the plain version's own distance plus the
    gate."""
    ins = _inputs((B, c, Q), H, P, N, seed=B + c + Q + H)
    got = _ssd_emulated(*_t(*ins))
    plain = ssd_chunk_batched_ref(*_t(*ins))
    pallas = ssd_chunk_pallas(*_j(*ins), interpret=True)
    for g, w, pw in zip(got, plain, pallas):
        assert bool(torch.isfinite(g).all())
        _close(g.numpy(), w.numpy())
        pw = torch.as_tensor(np.array(pw))
        assert bool(((g - pw).abs() <= (w - pw).abs() + TOL["atol"]
                     + TOL["rtol"] * pw.abs()).all())


def test_3xtf32_emulation_steep_decay():
    """dt near 0.1 and A near -16: acum falls by ~1.6 a row, so exp above
    the diagonal would overflow; the emulated kernel stays finite and
    within the gate."""
    rng = np.random.default_rng(7)
    f = np.float32
    lead, H, P, N = (1, 2, 256), 3, 64, 128
    x = rng.standard_normal(lead + (H, P)).astype(f)
    dt = rng.uniform(0.09, 0.11, lead + (H,)).astype(f)
    A = (-rng.uniform(15.0, 16.0, H)).astype(f)
    Bm = rng.standard_normal(lead + (N,)).astype(f)
    Cm = rng.standard_normal(lead + (N,)).astype(f)
    ins = (x, dt, A, Bm, Cm)
    got = _ssd_emulated(*_t(*ins))
    for g, w in zip(got, ssd_chunk_batched_ref(*_t(*ins))):
        assert bool(torch.isfinite(g).all())
        _close(g.numpy(), w.numpy())


def test_split_bf16_misses_the_card_gate():
    """The contrast: a bf16 split with three products (hi.hi + hi.lo +
    lo.hi) misses the element-wise 1e-4 gate at the path's P and N."""
    B, c, Q, H, P, N = 2, 1, 256, 5, 64, 128
    ins = _t(*_inputs((B, c, Q), H, P, N, seed=B + c + Q + H))
    want = ssd_chunk_batched_ref(*ins)
    worst = {}
    for name, split in (("tf32", _split_tf32), ("bf16", _split_bf16)):
        got = _ssd_emulated(*ins, split=split)
        worst[name] = max(float(((g - w).abs() / (1e-4 + 1e-4 * w.abs()))
                                .max()) for g, w in zip(got, want))
    assert worst["tf32"] <= 1.0 < worst["bf16"], worst
