"""The bf16 flash-attention forward's design, on the CPU.

The Hopper kernel (``kernels/attention/csrc/attention.cu``, namespace
``tc``) runs only on the card; here its host-visible plan and its
arithmetic are mirrored in Python, as ``test_torch_flash_bwd.py`` does
for the backward:

* the constants (rows of a CTA, rows of a K/V tile, ring stages,
  threads), read from the source;
* the CTA plan: one CTA of 64 query rows a (q block, head, batch),
  launched heaviest first; its K/V tiles run from the one that holds
  q0 - window + 1 to the diagonal (causal) or to T: every 64 x 64 block
  with an unmasked pair is visited exactly once, by the CTA's one
  consumer warpgroup, and no block left of the window or above the
  diagonal;
* a blocked emulation of the kernel's arithmetic in float32 torch:
  scores from bf16 inputs, the softcap's tanh in the kernel's form
  (1 - 2 / (1 + 2^(2 log2(e) x))), the window's and the causal mask, the
  online softmax in base 2 from a running max of -1e30, P split as P_hi
  = bf16(p) and P_lo = bf16(p - P_hi) for two bf16 products with V, the
  output acc / max(l, 1e-30) and the row's lse in base 2; held against
  the JAX package's attention (``attention_ref``, or with a softcap or
  a window its XLA form ``_chunked_attention``) at the card's bf16 gate
  (1e-3 abs + rel) at hd 256 with the cap and the window, and against
  the port's ``attention_lse_ref`` (1e-3); at 1.02 x scale, or with P
  as one bf16 product, it misses.
"""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke
from repro.kernels.attention.ref import attention_ref as j_attention_ref
from repro.models import attention as j_attn
from repro_torch.kernels.attention import kernel as AK
from repro_torch.kernels.attention.ref import (LOG2E, attention_lse_ref,
                                               attention_ref)

torch.set_num_threads(1)

_SRC = AK.SOURCE.read_text()
_TC = _SRC[_SRC.index("namespace tc {"):_SRC.index("}  // namespace tc")]
_C = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", _TC)}
BQ, BK = _C["BQ"], _C["BK"]      # q rows of a CTA, rows of a K/V tile
NEG = -1e30                      # the running max's start


def test_constants_are_the_documented_design():
    """A CTA: 64 query rows, one consumer warpgroup (128 threads) and a
    producer warp; K/V tiles of 64 rows in a ring of two stages."""
    assert (BQ, BK, _C["STAGES"], _C["NT"]) == (64, 64, 2, 128 + 32)


def first_tile(q0, window, n_tiles):
    """``first_tile``: the tile that holds q0 - window + 1 (0 without a
    window), at most the last one."""
    if window <= 0:
        return 0
    return min(max(q0 - window + 1, 0) // BK, n_tiles - 1)


def fwd_plan(B, S, T, H, causal, window=0):
    """The CTAs in launch order (blockIdx.x fastest, q blocks from the
    last one down): per CTA its visits (b, head, key block, q block), the
    tiles its one consumer warpgroup runs."""
    n_qb = -(-S // BQ)
    ctas = []
    for b in range(B):
        for h in range(H):
            for x in range(n_qb):
                qb = n_qb - 1 - x
                q0 = qb * BQ
                kv_end = min(q0 + BQ, T) if causal else T
                n_end = -(-kv_end // BK)
                j0 = first_tile(q0, window, n_end)
                ctas.append([(b, h, j, qb) for j in range(j0, n_end)])
    return ctas


def keep_mask(S, T, causal, window=0):
    """(S, T) True where query s keeps key t (``ref._keep``)."""
    s, t = np.arange(S)[:, None], np.arange(T)[None, :]
    keep = t <= s if causal else np.ones((S, T), bool)
    return keep & (t > s - window) if window else keep


def live_blocks(B, S, T, H, causal, window=0):
    keep = keep_mask(S, T, causal, window)
    out = set()
    for kb in range(-(-T // BK)):
        for qb in range(-(-S // BQ)):
            if keep[qb * BQ:qb * BQ + BQ, kb * BK:kb * BK + BK].any():
                out |= {(b, h, kb, qb) for b in range(B) for h in range(H)}
    return out


# (B, S, T, H, causal, window): gemma2's kind (causal, window 4096 at a
# cut length), S != T both ways, ragged, non-causal; windows leave every
# row a key (S < T + window), as the wrapper requires
PLAN_CASES = [(1, 8192, 8192, 2, True, 4096), (1, 8192, 8192, 2, True, 0),
              (2, 1000, 1000, 4, True, 300), (1, 333, 290, 4, True, 100),
              (1, 290, 333, 4, True, 70), (1, 300, 350, 2, False, 90),
              (2, 130, 130, 4, False, 0), (1, 77, 250, 4, True, 0)]


@pytest.mark.parametrize("B,S,T,H,causal,window", PLAN_CASES)
def test_plan_visits_every_live_block_once(B, S, T, H, causal, window):
    """Every 64 x 64 block with an unmasked pair is visited exactly once
    (by the CTA that owns its rows, whose one consumer warpgroup runs the
    tile), no block left of the window or above the diagonal; causal
    with S = T and no window the launch runs heaviest first."""
    ctas = fwd_plan(B, S, T, H, causal, window)
    visits = [v for cta in ctas for v in cta]
    assert len(visits) == len(set(visits))
    assert set(visits) == live_blocks(B, S, T, H, causal, window)
    if causal and S == T and not window:
        work = [len(c) for c in ctas[:-(-S // BQ)]]
        assert work == sorted(work, reverse=True)


def test_plan_at_gemma2_windowed_counts_the_window():
    """gemma2's prefill row (S = T = 8192, window 4096, causal): a q
    block past the window runs 65 tiles (the window's 64 and the one it
    straddles), the first runs 1, so the windowed call is ~3/4 of the
    global call's tiles."""
    ctas = fwd_plan(1, 8192, 8192, 1, True, 4096)
    work = [len(c) for c in ctas]
    assert work[0] == 65 and work[-1] == 1
    glob = sum(len(c) for c in fwd_plan(1, 8192, 8192, 1, True, 0))
    assert 0.74 < sum(work) / glob < 0.76


# -- the kernel's arithmetic --------------------------------------------------

def _bf16(x):
    return x.to(torch.bfloat16).float()


def softcap_tanh(x):
    """``hopper.cuh``'s softcap_tanh: 1 - 2 / (1 + 2^(2 log2(e) x))."""
    return 1 - 2 / (1 + torch.exp2(2 * LOG2E * x))


def emulate_fwd(q, k, v, *, causal=True, scale=None, softcap=None,
                window=0, split_p=True):
    """The bf16 kernel's arithmetic, CTA by CTA and tile by tile in the
    plan's order, in float32 torch -> (o (B, S, H, hd), lse (B, H, S)).
    ``split_p=False`` runs P.V as one bf16 product (a control)."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else hd ** -0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    keep = torch.as_tensor(keep_mask(S, T, causal, window))
    o = torch.zeros(B, S, H, hd)
    lse = torch.zeros(B, H, S)
    for cta in fwd_plan(B, S, T, H, causal, window):
        b, h, _, qb = cta[0]
        qs = slice(qb * BQ, min(qb * BQ + BQ, S))
        n = qs.stop - qs.start
        m = torch.full((n,), NEG)
        ll = torch.zeros(n)
        acc = torch.zeros(n, hd)
        for _, _, kb, _ in cta:
            ks = slice(kb * BK, min(kb * BK + BK, T))
            s = qf[b, qs, h] @ kf[b, ks, h // G].T
            if softcap:
                s = (softcap * LOG2E) * softcap_tanh(s * (scale / softcap))
            else:
                s = s * (scale * LOG2E)
            s = torch.where(keep[qs, ks], s, torch.tensor(float("-inf")))
            mx = torch.maximum(m, s.max(1).values)
            alpha = torch.exp2(m - mx)
            p = torch.exp2(s - mx[:, None])
            m, ll = mx, ll * alpha + p.sum(1)
            hi = _bf16(p)
            pv = (hi @ vf[b, ks, h // G] + _bf16(p - hi) @ vf[b, ks, h // G]
                  if split_p else hi @ vf[b, ks, h // G])
            acc = acc * alpha[:, None] + pv
        o[b, qs, h] = acc / torch.clamp(ll, min=1e-30)[:, None]
        lse[b, h, qs] = torch.where(ll > 0, m + torch.log2(ll),
                                    torch.tensor(float("inf")))
    return o, lse


def _inputs(shape, T, seed, qmul=1.0):
    B, S, H, K, hd = shape
    rng = np.random.default_rng(seed)
    mk = lambda *sh: torch.as_tensor(  # noqa: E731
        rng.standard_normal(sh).astype(np.float32))
    return ((mk(B, S, H, hd) * qmul).to(torch.bfloat16),
            mk(B, T, K, hd).to(torch.bfloat16),
            mk(B, T, K, hd).to(torch.bfloat16))


def jax_attention(q, k, v, causal, scale=None, softcap=None, window=0):
    """The JAX package's attention on the same bf16 values in float32:
    the kernels' reference ``attention_ref``, or with a softcap or a
    window its XLA attention's scanned form ``_chunked_attention``."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    scale = scale if scale is not None else hd ** -0.5
    qj, kj, vj = (jnp.asarray(t.float().numpy()) for t in (q, k, v))
    if softcap or window:
        cfg = dataclasses.replace(j_get_smoke("gemma2-2b"),
                                  attn_logit_softcap=softcap or 0.0,
                                  sliding_window=window)
        out = j_attn._chunked_attention(
            qj.reshape(B, S, K, H // K, hd), kj, vj, cfg,
            is_local=True if window else None, causal=causal, scale=scale,
            compute_dtype=jnp.float32)
        return np.asarray(out).reshape(B, S, H, hd)
    return np.asarray(j_attention_ref(qj, kj, vj, causal=causal,
                                      scale=scale))


def _within(got, want, tol):
    """The card's gate: |got - want| <= tol + tol |want| everywhere."""
    got, want = np.asarray(got), np.asarray(want)
    return bool(np.isfinite(got).all()
                and (np.abs(got - want) <= tol + tol * np.abs(want)).all())


# (shape (B, S, H, K, hd), T, causal, softcap, window, q multiplier): hd
# 256 with gemma2's cap and window (q x 8, so that the scores reach the
# cap's bend), global, ragged and non-causal; the padded hd 112 and hd 64
FWD_CASES = [((1, 200, 4, 2, 256), 200, True, 20.0, 60, 8),
             ((1, 150, 4, 2, 256), 150, True, 20.0, 0, 8),
             ((1, 130, 4, 4, 256), 100, False, None, 0, 1),
             ((1, 140, 2, 1, 256), 180, True, None, 50, 1),
             ((1, 150, 4, 2, 112), 200, True, None, 0, 1),
             ((2, 100, 4, 2, 64), 70, False, 30.0, 40, 4)]


@pytest.mark.parametrize("shape,T,causal,softcap,window,qmul", FWD_CASES,
                         ids=[f"{c[0]}-T{c[1]}-{c[2]}-cap{c[3]}-w{c[4]}"
                              for c in FWD_CASES])
def test_emulation_matches_jax_and_the_lse(shape, T, causal, softcap,
                                          window, qmul):
    """The emulated kernel within the card's bf16 gate (1e-3) of the JAX
    package's attention and of the port's plain version; its lse within
    1e-3 of ``attention_lse_ref``."""
    q, k, v = _inputs(shape, T, sum(shape) + T, qmul)
    kw = dict(causal=causal, softcap=softcap, window=window)
    o, lse = emulate_fwd(q, k, v, **kw)
    want = jax_attention(q, k, v, causal, softcap=softcap, window=window)
    assert _within(o, want, 1e-3)
    assert _within(o, attention_ref(q, k, v, **kw), 1e-3)
    assert float((lse - attention_lse_ref(q, k, **kw)).abs().max()) <= 1e-3


def test_emulation_controls_miss_the_gate():
    """The gate can fail: at gemma2's kind of call (hd 256, softcap,
    window, q x 8) the emulation at 1.02 x scale, and with P.V as one
    bf16 product (P's rounding 2^-9), miss 1e-3 against the JAX
    package's attention."""
    shape, T = (1, 200, 4, 2, 256), 200
    q, k, v = _inputs(shape, T, 11, 8)
    kw = dict(causal=True, softcap=20.0, window=60)
    want = jax_attention(q, k, v, True, softcap=20.0, window=60)
    o, _ = emulate_fwd(q, k, v, scale=1.02 * 256 ** -0.5, **kw)
    assert not _within(o, want, 1e-3)
    o, _ = emulate_fwd(q, k, v, split_p=False, **kw)
    assert not _within(o, want, 1e-3)
