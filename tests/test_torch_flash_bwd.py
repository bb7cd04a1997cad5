"""The bf16 flash-attention backward's design, on the CPU.

The Hopper kernels (``kernels/attention/csrc/attention_bwd.cu``, namespace
``tc``) run only on the card; here their host-visible plan and their
arithmetic are mirrored in Python:

* the persistent tile lists of the dK/dV kernel (a) and the dQ kernel
  (b), dealt to the CTAs in a snake: every (key block, q block, query
  head) block of 64 x 64 with an unmasked pair is visited exactly once by
  each kernel, causal-empty blocks never, tiles longest first;
* a blocked emulation of the kernels' arithmetic in plain torch, with
  their rounding points (dO, P and dS rounded to bf16 for the products,
  float32 sums, dQ summed over key blocks in ascending order), held
  against ``attention_bwd_ref`` and ``jax.grad`` of the JAX package's
  ``attention_ref`` at the bf16 tolerance the card's gate uses (1e-2).

The constants (block rows, warpgroups a CTA) are read from the source.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention.ref import attention_ref as j_attention_ref
from repro_torch.kernels.attention import kernel as AK
from repro_torch.kernels.attention.ref import (LOG2E, attention_bwd_ref,
                                               attention_lse_ref,
                                               attention_ref)

torch.set_num_threads(1)

_SRC = AK.SOURCE_BWD.read_text()
_C = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", _SRC)}
BM = _C["BM"]              # rows of a block
NWG = _C["NWG"]            # consumer warpgroups a CTA, 64 rows each
SMS = 132                  # an H100's SMs


def test_constants_are_the_documented_design():
    assert (BM, NWG) == (64, 2)
    assert _C["ROW_PAD"] == AK.BWD_ROW_PAD
    assert _C["ROW_PAD"] % (BM * NWG) == 0


def tile_of(c, i, grid, n_tiles):
    """``tc::tile_of``: the i-th tile of CTA c, or -1 past the list."""
    t = i * grid + (grid - 1 - c if i & 1 else c)
    return t if t < n_tiles else -1


def cta_tiles(c, grid, n_tiles):
    out, i = [], 0
    while (t := tile_of(c, i, grid, n_tiles)) >= 0:
        out.append(t)
        i += 1
    return out


def dkdv_plan(B, S, T, H, K, causal, nwg=NWG):
    """(a)'s tiles in list order: per tile (b, kv head, key block of 64
    nwg) the visits of each warpgroup, as (b, query head, key block of
    64, q block of 64)."""
    res, G = BM * nwg, H // K
    n_qb = -(-S // BM)
    tiles = []
    for t in range(-(-T // res) * K * B):
        kb, kh, b = t // (K * B), t % K, t // K % B
        k0 = kb * res
        qlo = min(k0 // BM, n_qb) if causal else 0
        nq = n_qb - qlo
        visits = []
        for j in range(nq * G):
            h, q0 = kh * G + j // nq, (qlo + j % nq) * BM
            for w in range(nwg):
                kw0 = k0 + BM * w
                if kw0 < T and (not causal or kw0 <= q0 + BM - 1):
                    visits.append((b, h, kw0 // BM, q0 // BM))
        tiles.append(visits)
    return tiles


def dq_plan(B, S, T, H, K, causal, nwg=NWG):
    """(b)'s tiles in list order: per tile (b, head, q block of 64 nwg)
    the visits of each warpgroup, as (b, head, key block, q block)."""
    res = BM * nwg
    n_rb = -(-S // res)
    tiles = []
    for t in range(n_rb * H * B):
        q0 = (n_rb - 1 - t // (H * B)) * res
        h, b = t % H, t // H % B
        end = min(q0 + res, T) if causal else T
        visits = []
        for j in range(-(-end // BM)):
            for w in range(nwg):
                qw0 = q0 + BM * w
                if qw0 < S and (not causal or j * BM <= qw0 + BM - 1):
                    visits.append((b, h, j, qw0 // BM))
        tiles.append(visits)
    return tiles


def live_blocks(B, S, T, H, causal):
    """Every (b, head, key block, q block) of 64 x 64 with an unmasked
    pair, from the mask itself."""
    out = set()
    for kb in range(-(-T // BM)):
        for qb in range(-(-S // BM)):
            keys = range(kb * BM, min(kb * BM + BM, T))
            last_q = min(qb * BM + BM, S) - 1
            if not causal or keys[0] <= last_q:
                out |= {(b, h, kb, qb) for b in range(B) for h in range(H)}
    return out


PLAN_CASES = [(2, 130, 130, 4, 2, True), (2, 130, 130, 4, 2, False),
              (1, 77, 250, 4, 4, True), (1, 250, 77, 8, 2, True),
              (1, 250, 77, 4, 1, False), (2, 333, 520, 4, 2, False),
              (2, 520, 333, 8, 2, True), (1, 64, 64, 2, 1, True),
              (1, 1000, 1000, 16, 8, True)]


@pytest.mark.parametrize("B,S,T,H,K,causal", PLAN_CASES)
@pytest.mark.parametrize("plan", [dkdv_plan, dq_plan])
def test_tiles_visit_every_live_block_once(plan, B, S, T, H, K, causal):
    """Each kernel visits every block with an unmasked pair exactly once
    and no causal-empty block; the snake deals every tile to exactly one
    CTA at any grid size; the list runs longest first, but for (b)'s
    ragged last row block, which leads the list with fewer live rows."""
    tiles = plan(B, S, T, H, K, causal)
    visits = [v for tile in tiles for v in tile]
    assert len(visits) == len(set(visits))
    assert set(visits) == live_blocks(B, S, T, H, causal)
    ragged = plan is dq_plan and S % (BM * NWG) != 0
    work = [len(tile) for tile in tiles[H * B if ragged else 0:]]
    assert work == sorted(work, reverse=True)
    for grid in (1, 7, SMS, len(tiles), len(tiles) + 5):
        dealt = [t for c in range(grid) for t in cta_tiles(c, grid,
                                                           len(tiles))]
        assert sorted(dealt) == list(range(len(tiles)))


@pytest.mark.parametrize("plan", [dkdv_plan, dq_plan])
def test_snake_balances_the_training_shape(plan):
    """At the training path's shape (2, 4096, 16, 8, 128) causal on 132
    CTAs, the busiest CTA carries at most the mean plus one tile of the
    work; dealt in plain rounds it would carry more."""
    tiles = plan(2, 4096, 4096, 16, 8, True)
    work = [len(t) for t in tiles]
    grid = min(SMS, len(tiles))
    snake = [sum(work[t] for t in cta_tiles(c, grid, len(work)))
             for c in range(grid)]
    rounds = [sum(work[c::grid]) for c in range(grid)]
    mean = sum(work) / grid
    assert sum(snake) == sum(work)
    assert max(snake) <= mean + max(work)
    assert max(snake) < max(rounds)


# -- the kernels' arithmetic --------------------------------------------------

def _bf16(x):
    return x.to(torch.bfloat16).float()


def emulate_bwd(q, k, v, o, do, lse, *, causal=True, scale=None,
                rounded=True):
    """The bf16 kernels' arithmetic in float32 torch, block by block: D =
    rowsum(dO o) from float32 dO; per 64 x 64 block S = q.k^T, P =
    2^(S scale log2(e) - lse) masked, dP = bf16(dO).v^T, dS = P (dP - D);
    dV += bf16(P)^T.bf16(dO) and dK += bf16(dS)^T.q over the (query head,
    q block) steps in (a)'s order; dQ += bf16(dS).k over the key blocks
    in ascending order, as (b) sums them.  -> (dq, dk, dv) float32.
    ``rounded=False`` drops the bf16 roundings (the blocked sums alone)."""
    rnd = _bf16 if rounded else (lambda x: x)
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else hd ** -0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    dof, dob = do.float(), rnd(do.float())
    delta = (dof * o.float()).sum(-1)                       # (B, S, H)
    dq = torch.zeros(B, S, H, hd)
    dk = torch.zeros(B, T, K, hd)
    dv = torch.zeros(B, T, K, hd)
    sl2 = scale * LOG2E

    def block(b, h, kb, qb):
        kh = h // G
        ks, qs = slice(kb * BM, min(kb * BM + BM, T)), \
            slice(qb * BM, min(qb * BM + BM, S))
        s = qf[b, qs, h] @ kf[b, ks, kh].T
        p = torch.exp2(s * sl2 - lse[b, h, qs, None])
        keys = torch.arange(ks.start, ks.stop)[None, :]
        rows = torch.arange(qs.start, qs.stop)[:, None]
        if causal:
            p = torch.where(keys <= rows, p, torch.zeros(()))
        dp = dob[b, qs, h] @ vf[b, ks, kh].T
        ds = p * (dp - delta[b, qs, h, None])
        return kh, ks, qs, p, ds

    live = live_blocks(B, S, T, H, causal)
    for visit in dkdv_order(B, S, T, H, K, causal):
        if visit not in live:
            continue
        b, h, kb, qb = visit
        kh, ks, qs, p, ds = block(*visit)
        dv[b, ks, kh] += rnd(p).T @ dob[b, qs, h]
        dk[b, ks, kh] += rnd(ds).T @ qf[b, qs, h]
    for b in range(B):
        for h in range(H):
            for qb in range(-(-S // BM)):
                for kb in range(-(-T // BM)):        # ascending
                    if (b, h, kb, qb) in live:
                        kh, ks, qs, _, ds = block(b, h, kb, qb)
                        dq[b, qs, h] += rnd(ds) @ kf[b, ks, kh]
    return dq * scale, dk * scale, dv


def dkdv_order(B, S, T, H, K, causal):
    """(a)'s visits in the order a warpgroup makes them: per key block,
    the group's query heads in turn, each over its q blocks."""
    return [v for tile in dkdv_plan(B, S, T, H, K, causal) for v in tile]


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / np.linalg.norm(np.asarray(b)))


def _inputs(shape, T, seed):
    B, S, H, K, hd = shape
    rng = np.random.default_rng(seed)
    mk = lambda *sh: torch.as_tensor(  # noqa: E731
        rng.standard_normal(sh).astype(np.float32)).to(torch.bfloat16)
    q, k, v = mk(B, S, H, hd), mk(B, T, K, hd), mk(B, T, K, hd)
    do = torch.as_tensor(rng.standard_normal((B, S, H, hd)).astype(
        np.float32))
    return q, k, v, do


def _jax_grads(q, k, v, do, causal, scale):
    def f(q, k, v):
        out = j_attention_ref(q, k, v, causal=causal, scale=scale)
        return jnp.sum(out * jnp.asarray(do.numpy()))
    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(t.float().numpy()) for t in (q, k, v)))]


# (shape (B,S,H,K,hd), T, causal, scale): GQA 1, 2 and 4, S != T both
# ways, S and T not multiples of 64, non-causal, every head dim
EMU_CASES = [((1, 130, 4, 2, 16), 130, True, None),
             ((1, 77, 4, 1, 32), 150, True, 0.2),
             ((1, 150, 8, 2, 16), 77, True, None),
             ((1, 100, 4, 4, 64), 70, False, None),
             ((1, 70, 2, 1, 128), 100, False, 0.1)]


@pytest.mark.parametrize("shape,T,causal,scale", EMU_CASES,
                         ids=[f"{c[0]}-T{c[1]}-{c[2]}" for c in EMU_CASES])
def test_emulation_matches_the_plain_backward_and_jax(shape, T, causal,
                                                      scale):
    """The emulated kernels within 1e-2 (rel L2, the card's bf16 gate) of
    the float32 backward and of jax.grad; further than float32 rounding
    from them (its bf16 roundings are live), and without them the blocked
    sums agree with the plain backward to 1e-5."""
    q, k, v, do = _inputs(shape, T, sum(shape) + T)
    o = attention_ref(q, k, v, causal=causal, scale=scale)
    lse = attention_lse_ref(q, k, causal=causal, scale=scale)
    got = emulate_bwd(q, k, v, o, do, lse, causal=causal, scale=scale)
    want = attention_bwd_ref(q, k, v, o, do, causal=causal, scale=scale)
    jax_g = _jax_grads(q, k, v, do, causal, scale)
    for g, w, j in zip(got, want, jax_g):
        assert bool(torch.isfinite(g).all())
        assert 1e-4 < _rel(g, w) <= 1e-2
        assert _rel(g, j) <= 1e-2
        assert _rel(w, j) <= 1e-5
    exact = emulate_bwd(q, k, v, o, do, lse, causal=causal, scale=scale,
                        rounded=False)
    for g, w in zip(exact, want):
        assert _rel(g, w) <= 1e-5


def test_emulation_key_tail_shorter_than_a_block():
    """Causal with T (5) far below S and below a block: the q blocks past
    the last key see all five keys, and the partial key block is summed
    like a whole one."""
    q, k, v, do = _inputs((1, 70, 2, 1, 16), 5, 3)
    o = attention_ref(q, k, v, causal=True)
    lse = attention_lse_ref(q, k, causal=True)
    got = emulate_bwd(q, k, v, o, do, lse, causal=True)
    want = attention_bwd_ref(q, k, v, o, do, causal=True)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert _rel(g, w) <= 1e-2
