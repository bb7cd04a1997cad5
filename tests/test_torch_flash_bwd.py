"""The bf16 flash-attention backward's design, on the CPU.

The Hopper kernels (``kernels/attention/csrc/attention_bwd.cu``, namespace
``tc``) run only on the card; here their host-visible plan and their
arithmetic are mirrored in Python:

* the persistent tile lists of the dK/dV kernel (a) and the dQ kernel
  (b), dealt to the CTAs in a snake: every (key block, q block, query
  head) block of 64 x 64 with an unmasked pair is visited exactly once by
  each kernel, causal-empty blocks and blocks left of a sliding window
  never, tiles longest first (under a window too);
* the prep kernel's lane map: every row's head dims summed exactly once,
  by lanes of one warp, at every head dim;
* a blocked emulation of the kernels' arithmetic in plain torch, with
  their rounding points (dO, P and dS rounded to bf16 for the products,
  float32 sums, dQ summed over key blocks in ascending order), the
  softcap's 1 - t^2 factor and the window's mask, hd 112 on zero-padded
  128-wide tiles and hd 256 split between the two warpgroups (each
  scores its 32-wide half of a block once and exchanges bf16 P^T and
  dS^T (dS) through shared tiles; each owns half the dK/dV/dQ columns),
  held against ``attention_bwd_ref`` and ``jax.grad`` of the JAX
  package's attention at the bf16 tolerance the card's gate uses (1e-2);
* the products a block issues on the split geometry, counted from the
  kernels' own issue calls on the path each instance compiles, with
  the widths of their accumulators as declared: 4 units of 64 x 64 x
  256 in (a) and 3 in (b) at hd 256.

The constants (block rows, warpgroups a CTA) are read from the source.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke
from repro.kernels.attention.ref import attention_ref as j_attention_ref
from repro.models import attention as j_attn
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


def _split(hd):
    """hd 256's geometry: the two warpgroups split the columns of one
    64-row block (``tc::Geo::SPLIT``), so a CTA holds 64 rows, not
    64 NWG, and each scores its half of the block's other side."""
    return hd > 128


# the score accumulators a consumer thread holds, split or not
# (``constexpr int NS = G::SPLIT ? 16 : 32;`` in both kernels): a m64nN
# f32 accumulator is N / 2 registers a thread
_NS = re.findall(r"constexpr int NS = G::SPLIT \? (\d+) : (\d+);", _SRC)
HALF = 2 * int(_NS[0][0])     # a split warpgroup's score columns


def dkdv_plan(B, S, T, H, K, causal, window=0, split=False, nwg=NWG):
    """(a)'s tiles in list order: per tile (b, kv head, key block of 64
    nwg, or 64 split) a pair (its visits, whether its key block is the
    ragged last one); the visits of each warpgroup as (b, query head, key
    block of 64, q block of 64), a split CTA's as (b, query head, key
    block, q block, w): warpgroup w scores the block's queries 32 w ..
    32 w + 31."""
    res, G = (BM if split else BM * nwg), H // K
    n_qb, n_kb = -(-S // BM), -(-T // res)
    tiles = []
    for t in range(n_kb * K * B):
        kb, kh, b = t // (K * B), t % K, t // K % B
        k0 = kb * res
        lo = min(k0 // BM, n_qb) if causal else 0
        hi = (min(n_qb, (k0 + res - 1 + window - 1) // BM + 1) if window
              else n_qb)
        nq = hi - lo
        visits = []
        for j in range(max(nq, 0) * G):
            h, q0 = kh * G + j // nq, (lo + j % nq) * BM
            for w in range(1 if split else nwg):
                kw0 = k0 + BM * w
                if (kw0 < T and (not causal or kw0 <= q0 + BM - 1)
                        and (not window or q0 < kw0 + 63 + window)):
                    block = (b, h, kw0 // BM, q0 // BM)
                    visits += ([block + (u,) for u in range(nwg)] if split
                               else [block])
        tiles.append((visits, T % res != 0 and kb == n_kb - 1))
    return tiles


def dq_plan(B, S, T, H, K, causal, window=0, split=False, nwg=NWG):
    """(b)'s tiles in list order: per tile (b, head, q block of 64 nwg,
    or 64 split) a pair (its visits, whether its rows are the ragged last
    block); the visits of each warpgroup as (b, head, key block, q
    block), a split CTA's as (b, head, key block, q block, w): warpgroup
    w scores the block's keys 32 w .. 32 w + 31."""
    res = BM if split else BM * nwg
    n_rb = -(-S // res)
    tiles = []
    for t in range(n_rb * H * B):
        rb = n_rb - 1 - t // (H * B)
        q0 = rb * res
        h, b = t % H, t // H % B
        end = min(q0 + res, T) if causal else T
        j0 = max(q0 - window + 1, 0) // BM if window else 0
        visits = []
        for j in range(j0, -(-end // BM)):
            for w in range(1 if split else nwg):
                qw0 = q0 + BM * w
                if (qw0 < S and (not causal or j * BM <= qw0 + BM - 1)
                        and (not window or j * BM + 63 + window > qw0)):
                    block = (b, h, j, qw0 // BM)
                    visits += ([block + (u,) for u in range(nwg)] if split
                               else [block])
        tiles.append((visits, S % res != 0 and rb == n_rb - 1))
    return tiles


def keep_mask(S, T, causal, window=0):
    """(S, T) True where query s keeps key t (``ref._keep``)."""
    s, t = np.arange(S)[:, None], np.arange(T)[None, :]
    keep = t <= s if causal else np.ones((S, T), bool)
    return keep & (t > s - window) if window else keep


def live_blocks(B, S, T, H, causal, window=0):
    """Every (b, head, key block, q block) of 64 x 64 with an unmasked
    pair, from the mask itself."""
    keep = keep_mask(S, T, causal, window)
    out = set()
    for kb in range(-(-T // BM)):
        for qb in range(-(-S // BM)):
            if keep[qb * BM:qb * BM + BM, kb * BM:kb * BM + BM].any():
                out |= {(b, h, kb, qb) for b in range(B) for h in range(H)}
    return out


PLAN_CASES = [(2, 130, 130, 4, 2, True), (2, 130, 130, 4, 2, False),
              (1, 77, 250, 4, 4, True), (1, 250, 77, 8, 2, True),
              (1, 250, 77, 4, 1, False), (2, 333, 520, 4, 2, False),
              (2, 520, 333, 8, 2, True), (1, 64, 64, 2, 1, True),
              (1, 1000, 1000, 16, 8, True)]


def _check_plan(plan, B, S, T, H, K, causal, window=0, split=False):
    """Every block with an unmasked pair visited exactly once, no
    causal-empty block or block left of the window; the snake deals every
    tile to exactly one CTA at any grid size; the list runs longest
    first, but for (b)'s ragged last row block, which leads the list with
    fewer live rows, and but for a window that is not causal (no path
    makes one; its work grows with the key and falls with the row) or has
    S > T (the rows past T lose keys at both ends)."""
    tiles = plan(B, S, T, H, K, causal, window, split)
    visits = [v for tile, _ in tiles for v in tile]
    assert len(visits) == len(set(visits))
    live = live_blocks(B, S, T, H, causal, window)
    if split:   # each live block's two halves, one a warpgroup
        assert set(visits) == {blk + (w,) for blk in live
                               for w in range(NWG)}
    else:
        assert set(visits) == live
    work = [len(tile) for tile, ragged in tiles
            if not (ragged and plan is dq_plan)]
    if not window or (causal and S <= T):
        assert work == sorted(work, reverse=True)
    for grid in (1, 7, SMS, len(tiles), len(tiles) + 5):
        dealt = [t for c in range(grid) for t in cta_tiles(c, grid,
                                                           len(tiles))]
        assert sorted(dealt) == list(range(len(tiles)))


@pytest.mark.parametrize("B,S,T,H,K,causal", PLAN_CASES)
@pytest.mark.parametrize("plan", [dkdv_plan, dq_plan])
def test_tiles_visit_every_live_block_once(plan, B, S, T, H, K, causal):
    """Each kernel visits every block with an unmasked pair exactly once
    and no causal-empty block (``_check_plan``)."""
    _check_plan(plan, B, S, T, H, K, causal)


# (B, S, T, H, K, causal, window, split): windows that leave every row a
# key (S < T + window), causal or not, S != T, and hd 256's split tiles
WINDOW_PLAN_CASES = [(1, 1000, 1000, 4, 2, True, 200, False),
                     (2, 333, 290, 4, 2, True, 100, False),
                     (1, 520, 333, 4, 1, True, 300, False),
                     (1, 300, 350, 4, 2, False, 90, False),
                     (1, 250, 300, 2, 2, True, 45, False),
                     (2, 1000, 1000, 8, 4, True, 0, True),
                     (1, 1000, 1000, 8, 4, True, 300, True),
                     (1, 333, 290, 4, 2, False, 70, True),
                     (1, 200, 270, 4, 1, False, 0, True)]


@pytest.mark.parametrize("B,S,T,H,K,causal,window,split",
                         WINDOW_PLAN_CASES)
@pytest.mark.parametrize("plan", [dkdv_plan, dq_plan])
def test_windowed_and_split_tiles_visit_every_live_block_once(
        plan, B, S, T, H, K, causal, window, split):
    """The same under a sliding window ((a) walks a key block's q blocks
    up to its last key + window - 1, (b) starts at the key block holding
    q0 - window + 1) and on hd 256's 64-row split tiles: no block left of
    the window is visited, the causal lists stay longest first."""
    _check_plan(plan, B, S, T, H, K, causal, window, split)


_KERNELS = {"a": "flash_bwd_dkdv_wgmma_kernel", "b": "flash_bwd_dq_wgmma_kernel"}
_CODE = re.sub(r"//[^\n]*", "", _SRC)    # the source without comments


def _block_end(text, i):
    """The index past the brace block that opens at text[i]."""
    depth = 0
    for j in range(i, len(text)):
        depth += {"{": 1, "}": -1}.get(text[j], 0)
        if depth == 0:
            return j + 1
    raise ValueError("unbalanced braces")


def _kernel_path(kernel, split):
    """The body of kernel (a) or (b) as its split (or unsplit) instances
    compile it: each ``if constexpr (G::SPLIT) {...} else {...}`` reduced
    to the side that instance takes."""
    a = re.search(rf"{_KERNELS[kernel]}\([^)]*\)\s*\{{", _CODE).end() - 1
    body, out, i = _CODE[a:_block_end(_CODE, a)], "", 0
    key = "if constexpr (G::SPLIT) {"
    while (j := body.find(key, i)) >= 0:
        then_end = _block_end(body, j + len(key) - 1)
        other = re.match(r"\s*else\s*\{", body[then_end:])
        end = (_block_end(body, then_end + other.end() - 1) if other
               else then_end)
        out += body[i:j] + (body[j:then_end] if split
                            else body[then_end:end])
        i = end
    return out + body[i:]


def issue_list(kernel, hd, score_split=True):
    """What one consumer warpgroup issues a live step, as (accumulator,
    M, N, K) of its wgmma, read from ``tc::flash_bwd_dkdv_wgmma_kernel``
    ("a") and ``tc::flash_bwd_dq_wgmma_kernel`` ("b") on the path their
    instances at ``hd`` compile: every ``issue_nt``/``issue_xn``/
    ``issue_nn`` call, N from the declared width of its accumulator
    (``st[NS]``, ``adk[HA / 2]``: a m64nN f32 accumulator is N / 2
    registers a thread, NS read from the kernel), K from the helper's
    k-loop (``HD / 16`` or ``BM / 16`` k-steps).  ``score_split=False``
    gives the split path the unsplit score width, each warpgroup scoring
    the whole block: the column split alone, the design before."""
    hdp = -(-hd // 64) * 64 if hd > 64 else hd
    split = _split(hd)
    body = _kernel_path(kernel, split)
    ns = re.search(r"constexpr int NS = G::SPLIT \? (\d+) : (\d+);", body)
    regs = {"NS": int(ns.group(1 if split and score_split else 2)),
            "HA / 2": (hdp // NWG if split else hdp) // 2}
    width = dict(re.findall(r"(\w+)\[(NS|HA / 2)\]", body))
    ksteps = {kind: re.search(r"kk < (\w+) / 16", _CODE[_CODE.index(
        f"void issue_{kind}("):]).group(1) for kind in ("nt", "xn", "nn")}
    return [(acc, BM, 2 * regs[width[acc]], hd if ksteps[kind] == "HD"
             else BM)
            for kind, acc in re.findall(r"issue_(nt|xn|nn)<[^>]*>\((\w+),",
                                        body)]


def block_units(kernel, hd, score_split=True):
    """Products a live 64 x 64 block costs, in units of one 64 x 64 x hd
    product: every warpgroup that visits the block issues its list."""
    per_wg = sum(m * n * kk for _, m, n, kk in issue_list(
        kernel, hd, score_split)) / (BM * BM * hd)
    return per_wg * (NWG if _split(hd) else 1)


def test_split_blocks_score_once_and_issue_seven_units():
    """At hd 256 a block's S^T and dP^T (S and dP) come from one
    warpgroup's half each, never twice: (a) issues 4 product units and
    (b) 3, against 6 and 5 when each warpgroup scored the whole block
    (the unsplit design issues 4 and 3 as well); counted over gemma2's
    windowed plan, every unit is a live block's.  The counts come from
    the kernels' own issue calls and accumulator widths; the header
    comment of attention_bwd.cu states the same."""
    assert HALF == BM // NWG == 32
    assert [acc for acc, *_ in issue_list("a", 256)] == [
        "st", "dpt", "adv", "adk"]
    assert [acc for acc, *_ in issue_list("b", 256)] == ["sc", "dp", "adq"]
    assert (block_units("a", 256), block_units("b", 256)) == (4, 3)
    assert (block_units("a", 256, score_split=False),
            block_units("b", 256, score_split=False)) == (6, 5)
    assert (block_units("a", 128), block_units("b", 128)) == (4, 3)
    flat = " ".join(line.strip().lstrip("/").strip()
                    for line in _SRC.splitlines())
    assert "(a) issues 4 (S^T, dP^T, dV, dK) and (b) 3 (S, dP, dQ)" in flat
    B, S, H, K = 1, 1024, 4, 2
    live = live_blocks(B, S, S, H, True, 300)
    for kernel, plan in (("a", dkdv_plan), ("b", dq_plan)):
        visits = [v for tile, _ in plan(B, S, S, H, K, True, 300, True)
                  for v in tile]
        per_visit = block_units(kernel, 256) / NWG
        assert len(visits) * per_visit == len(live) * block_units(
            kernel, 256)


@pytest.mark.parametrize("plan", [dkdv_plan, dq_plan])
def test_snake_balances_the_training_shape(plan):
    """At the training path's shape (2, 4096, 16, 8, 128) causal on 132
    CTAs, the busiest CTA carries at most the mean plus one tile of the
    work; dealt in plain rounds it would carry more."""
    tiles = plan(2, 4096, 4096, 16, 8, True)
    work = [len(t) for t, _ in tiles]
    grid = min(SMS, len(tiles))
    snake = [sum(work[t] for t in cta_tiles(c, grid, len(work)))
             for c in range(grid)]
    rounds = [sum(work[c::grid]) for c in range(grid)]
    mean = sum(work) / grid
    assert sum(snake) == sum(work)
    assert max(snake) <= mean + max(work)
    assert max(snake) < max(rounds)


# (shape (B, S, H, K, hd), window): zamba2's and gemma2's windowed one
BALANCE_CASES = [((1, 4096, 32, 32, 112), 0), ((1, 8192, 8, 4, 256), 4096)]


@pytest.mark.parametrize("shape,window", BALANCE_CASES,
                         ids=[str(c[0][-1]) for c in BALANCE_CASES])
@pytest.mark.parametrize("plan", [dkdv_plan, dq_plan])
def test_snake_balances_the_new_path_shapes(plan, shape, window):
    """At zamba2's and gemma2's shapes, causal (windowed at gemma2's), on
    132 CTAs, on their geometries (hd 256 split):
    the busiest CTA carries at most the mean plus one tile of the work,
    and less than dealt in plain rounds."""
    B, S, H, K, hd = shape
    tiles = plan(B, S, S, H, K, True, window, _split(hd))
    work = [len(t) for t, _ in tiles]
    grid = min(SMS, len(tiles))
    snake = [sum(work[t] for t in cta_tiles(c, grid, len(work)))
             for c in range(grid)]
    rounds = [sum(work[c::grid]) for c in range(grid)]
    mean = sum(work) / grid
    assert sum(snake) == sum(work)
    assert max(snake) <= mean + max(work)
    assert max(snake) < max(rounds)


def prep_lanes(hd):
    """``tc::prep_lanes``: the largest power of two dividing hd / 4, at
    most 32."""
    c4 = hd // 4
    return min(c4 & -c4, 32)


@pytest.mark.parametrize("hd", AK.HEAD_DIMS)
def test_prep_lane_map_sums_each_row_once_inside_a_warp(hd):
    """The prep kernel's map of 256-thread blocks onto rows: L lanes a
    row, each over float4 chunks part, part + L, ...: every head dim of
    every row summed exactly once; a row's lanes in one warp and its
    butterfly partners (XOR L/2 .. 1) in the same row; D in that order
    equal to the row's float64 sum to float32 rounding."""
    assert "prep_lanes<HD>()" in _SRC
    L = prep_lanes(hd)
    assert 32 % L == 0 and (hd // 4) % L == 0
    rows = 3 * 256 // L + 5                  # blocks' rows, a tail
    tid = np.arange(-(-rows * L // 256) * 256)
    row, part = tid // L, tid % L
    live = row < rows
    chunks = [(part + L * c) * 4 for c in range(hd // 4 // L)]
    cover = np.zeros((rows, hd), int)
    for c0 in chunks:
        for d in range(4):
            np.add.at(cover, (row[live], c0[live] + d), 1)
    assert (cover == 1).all()
    assert (np.unique(np.stack([row // (32 // L), tid // 32]), axis=1)
            .shape[1] == len(np.unique(tid // 32)))
    for m in [L >> i for i in range(1, 6) if L >> i]:
        assert ((part ^ m) < L).all()
    rng = np.random.default_rng(hd)
    g = rng.standard_normal((rows, hd)).astype(np.float32)
    y = rng.standard_normal((rows, hd)).astype(np.float32)
    lane = np.zeros((rows, L), np.float32)
    for c in range(hd // 4 // L):
        for p in range(L):
            for d in range(4):
                col = (p + L * c) * 4 + d
                lane[:, p] = lane[:, p] + g[:, col] * y[:, col]
    m = L // 2
    while m:
        lane = lane + lane[:, np.arange(L) ^ m]
        m //= 2
    want = (g.astype(np.float64) * y).sum(1)
    assert np.allclose(lane, lane[:, :1])
    np.testing.assert_allclose(lane[:, 0], want, rtol=1e-5, atol=1e-5)


# -- the kernels' arithmetic --------------------------------------------------

def _bf16(x):
    return x.to(torch.bfloat16).float()


def emulate_bwd(q, k, v, o, do, lse, *, causal=True, scale=None,
                softcap=None, window=0, rounded=True):
    """The bf16 kernels' arithmetic in float32 torch, block by block: D =
    rowsum(dO o) from float32 dO; per 64 x 64 block S = q.k^T, its
    exponent s' (scale s log2(e), or cap log2(e) t with t = tanh(scale s
    / cap)), P = 2^(s' - lse) masked (causal, window), dP = bf16(dO).v^T,
    dS = P (1 - t^2) (dP - D); dV += bf16(P)^T.bf16(dO) and dK +=
    bf16(dS)^T.q over the (query head, q block) steps in (a)'s order; dQ
    += bf16(dS).k over the key blocks in ascending order, as (b) sums
    them.  hd 112 runs on 128 columns, the last 16 zeros (the TMA's
    fill), and keeps 112.  At hd 256 the plans' visits are 32-wide halves:
    each half of a block is scored exactly once, by its warpgroup, into
    bf16 exchange tiles (P^T and dS^T in (a), dS in (b)), which both
    warpgroups then read for their half of the dV, dK (dQ) columns.  ->
    (dq, dk, dv) float32.  ``rounded=False`` drops the bf16 roundings
    (the blocked sums alone)."""
    B, S, H, hd = q.shape
    scale = scale if scale is not None else hd ** -0.5
    hdp = -(-hd // 64) * 64 if hd > 64 else hd
    if hdp != hd:
        def pad(t):
            return torch.nn.functional.pad(t.float(), (0, hdp - hd))
        got = emulate_bwd(pad(q), pad(k), pad(v), pad(o), pad(do), lse,
                          causal=causal, scale=scale, softcap=softcap,
                          window=window, rounded=rounded)
        return tuple(g[..., :hd] for g in got)
    rnd = _bf16 if rounded else (lambda x: x)
    T, K = k.shape[1], k.shape[2]
    G = H // K
    split = _split(hd)
    halves = ([slice(0, hd // 2), slice(hd // 2, hd)] if split
              else [slice(0, hd)])
    qf, kf, vf = q.float(), k.float(), v.float()
    dof, dob = do.float(), rnd(do.float())
    delta = (dof * o.float()).sum(-1)                       # (B, S, H)
    dq = torch.zeros(B, S, H, hd)
    dk = torch.zeros(B, T, K, hd)
    dv = torch.zeros(B, T, K, hd)
    keep = torch.as_tensor(keep_mask(S, T, causal, window))

    def rows(lo, n, end):
        return slice(min(lo, end), min(lo + n, end))

    def part(b, h, ks, qs):
        """P and dS (queries x keys) of the pair block (qs, ks)."""
        kh = h // G
        s = qf[b, qs, h] @ kf[b, ks, kh].T
        if softcap:
            t = torch.tanh(s * (scale / softcap))
            x = (softcap * LOG2E) * t
        else:
            t, x = torch.zeros(()), s * (scale * LOG2E)
        p = torch.exp2(x - lse[b, h, qs, None])
        p = torch.where(keep[qs, ks], p, torch.zeros(()))
        dp = dob[b, qs, h] @ vf[b, ks, kh].T
        ds = p * (1 - t * t) * (dp - delta[b, qs, h, None])
        return p, ds

    live = live_blocks(B, S, T, H, causal, window)
    scored = set()      # (kernel, visit): each half scored once
    tiles = {}          # the exchange tiles of the block in hand
    for visit in dkdv_order(B, S, T, H, K, causal, window, split):
        b, h, kb, qb = visit[:4]
        if visit[:4] not in live:
            continue
        kh = h // G
        ks, qs = rows(kb * BM, BM, T), rows(qb * BM, BM, S)
        if split:               # warpgroup w scores queries 32 w ..
            w = visit[4]
            assert ("a", visit) not in scored
            scored.add(("a", visit))
            if w == 0:
                n = qs.stop - qs.start
                tiles = {"p": torch.zeros(ks.stop - ks.start, n),
                         "ds": torch.zeros(ks.stop - ks.start, n)}
            hs = rows(qb * BM + HALF * w, HALF, S)
            p, ds = part(b, h, ks, hs)
            cols = slice(hs.start - qs.start, hs.stop - qs.start)
            tiles["p"][:, cols], tiles["ds"][:, cols] = rnd(p).T, rnd(ds).T
            if w < NWG - 1:
                continue
            pt, dst = tiles["p"], tiles["ds"]
        else:
            p, ds = part(b, h, ks, qs)
            pt, dst = rnd(p).T, rnd(ds).T
        for c in halves:    # each warpgroup's columns, the whole block
            dv[b, ks, kh, c] += pt @ dob[b, qs, h, c]
            dk[b, ks, kh, c] += dst @ qf[b, qs, h, c]
    if split:
        for tile, _ in dq_plan(B, S, T, H, K, causal, window, split):
            for visit in tile:          # key blocks ascending, halves
                b, h, kb, qb, w = visit
                if visit[:4] not in live:
                    continue
                assert ("b", visit) not in scored
                scored.add(("b", visit))
                kh = h // G
                ks, qs = rows(kb * BM, BM, T), rows(qb * BM, BM, S)
                if w == 0:
                    tiles = {"ds": torch.zeros(qs.stop - qs.start,
                                               ks.stop - ks.start)}
                hk = rows(kb * BM + HALF * w, HALF, T)
                _, ds = part(b, h, hk, qs)
                cols = slice(hk.start - ks.start, hk.stop - ks.start)
                tiles["ds"][:, cols] = rnd(ds)
                if w == NWG - 1:
                    for c in halves:
                        dq[b, qs, h, c] += tiles["ds"] @ kf[b, ks, kh, c]
    else:
        for b in range(B):
            for h in range(H):
                for qb in range(-(-S // BM)):
                    for kb in range(-(-T // BM)):        # ascending
                        if (b, h, kb, qb) in live:
                            ks = rows(kb * BM, BM, T)
                            qs = rows(qb * BM, BM, S)
                            _, ds = part(b, h, ks, qs)
                            for c in halves:
                                dq[b, qs, h, c] += rnd(ds) @ kf[
                                    b, ks, h // G, c]
    return dq * scale, dk * scale, dv


def dkdv_order(B, S, T, H, K, causal, window=0, split=False):
    """(a)'s visits in the order a warpgroup makes them: per key block,
    the group's query heads in turn, each over its q blocks."""
    return [v for tile, _ in dkdv_plan(B, S, T, H, K, causal, window, split)
            for v in tile]


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / np.linalg.norm(np.asarray(b)))


def _inputs(shape, T, seed, qmul=1.0):
    B, S, H, K, hd = shape
    rng = np.random.default_rng(seed)
    mk = lambda *sh: torch.as_tensor(  # noqa: E731
        rng.standard_normal(sh).astype(np.float32))
    q = (mk(B, S, H, hd) * qmul).to(torch.bfloat16)
    k, v = mk(B, T, K, hd).to(torch.bfloat16), mk(B, T, K, hd).to(
        torch.bfloat16)
    do = mk(B, S, H, hd)
    return q, k, v, do


def _jax_grads(q, k, v, do, causal, scale, softcap=None, window=0):
    """jax.grad of the JAX package's attention: the kernels' reference
    ``attention_ref``, or with a softcap or a window its XLA attention's
    scanned form ``_chunked_attention`` (which has both)."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    if softcap or window:
        cfg = dataclasses.replace(j_get_smoke("gemma2-2b"),
                                  attn_logit_softcap=softcap or 0.0,
                                  sliding_window=window)
        scale = scale if scale is not None else hd ** -0.5

        def attend(q, k, v):
            out = j_attn._chunked_attention(
                q.reshape(B, S, K, H // K, hd), k, v, cfg,
                is_local=True if window else None, causal=causal,
                scale=scale, compute_dtype=jnp.float32)
            return out.reshape(B, S, H, hd)
    else:
        def attend(q, k, v):
            return j_attention_ref(q, k, v, causal=causal, scale=scale)

    def f(q, k, v):
        return jnp.sum(attend(q, k, v) * jnp.asarray(do.numpy()))
    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(t.float().numpy()) for t in (q, k, v)))]


# (shape (B,S,H,K,hd), T, causal, scale, softcap, window, q multiplier):
# GQA 1, 2 and 4, S != T both ways, S and T not multiples of 64,
# non-causal, every head dim; hd 112 on its zero-padded tiles, hd 256 on
# its split columns, the softcap (q x 8, so that the scores reach its
# bend) and the window (S < T + window)
EMU_CASES = [((1, 130, 4, 2, 16), 130, True, None, None, 0, 1),
             ((1, 77, 4, 1, 32), 150, True, 0.2, None, 0, 1),
             ((1, 150, 8, 2, 16), 77, True, None, None, 0, 1),
             ((1, 100, 4, 4, 64), 70, False, None, None, 0, 1),
             ((1, 70, 2, 1, 128), 100, False, 0.1, None, 0, 1),
             ((1, 150, 4, 2, 112), 200, True, None, None, 0, 1),
             ((1, 130, 4, 1, 112), 90, False, 0.1, None, 0, 1),
             ((1, 140, 4, 2, 112), 150, True, None, 20.0, 70, 8),
             ((1, 130, 4, 2, 256), 100, False, None, None, 0, 1),
             ((1, 140, 4, 2, 256), 160, True, None, 20.0, 60, 8),
             ((1, 150, 4, 2, 128), 150, True, None, 20.0, 0, 8),
             ((1, 150, 2, 1, 64), 180, True, None, None, 50, 1),
             ((1, 130, 2, 2, 32), 150, False, None, None, 40, 1)]


def _emu_id(c):
    base = f"{c[0]}-T{c[1]}-{c[2]}"
    return base if c[4] is None and not c[5] else (
        f"{base}-cap{c[4]}-w{c[5]}")


@pytest.mark.parametrize("shape,T,causal,scale,softcap,window,qmul",
                         EMU_CASES, ids=[_emu_id(c) for c in EMU_CASES])
def test_emulation_matches_the_plain_backward_and_jax(shape, T, causal,
                                                      scale, softcap, window,
                                                      qmul):
    """The emulated kernels within 1e-2 (rel L2, the card's bf16 gate) of
    the float32 backward and of jax.grad; further than float32 rounding
    from them (its bf16 roundings are live), and without them the blocked
    sums agree with the plain backward to 1e-5; the plain backward within
    1e-5 of jax.grad."""
    q, k, v, do = _inputs(shape, T, sum(shape) + T, qmul)
    kw = dict(causal=causal, scale=scale, softcap=softcap, window=window)
    o = attention_ref(q, k, v, **kw)
    lse = attention_lse_ref(q, k, **kw)
    got = emulate_bwd(q, k, v, o, do, lse, **kw)
    want = attention_bwd_ref(q, k, v, o, do, **kw)
    jax_g = _jax_grads(q, k, v, do, causal, scale, softcap, window)
    for g, w, j in zip(got, want, jax_g):
        assert bool(torch.isfinite(g).all())
        assert 1e-4 < _rel(g, w) <= 1e-2
        assert _rel(g, j) <= 1e-2
        assert _rel(w, j) <= 1e-5
    exact = emulate_bwd(q, k, v, o, do, lse, rounded=False, **kw)
    for g, w in zip(exact, want):
        assert _rel(g, w) <= 1e-5


def test_emulation_controls_miss_the_gate():
    """The gate can fail: at gemma2's kind of call (hd 256, softcap,
    window) the emulation with the softcap's 1 - t^2 dropped, with the
    window's mask dropped, or at 1.02 x scale misses 1e-2."""
    q, k, v, do = _inputs((1, 140, 4, 2, 256), 160, 11, 8)
    kw = dict(causal=True, softcap=20.0, window=60)
    o = attention_ref(q, k, v, **kw)
    lse = attention_lse_ref(q, k, **kw)
    want = attention_bwd_ref(q, k, v, o, do, **kw)
    for off in (dict(softcap=None), dict(window=0),
                dict(scale=1.02 * 256 ** -0.5)):
        got = emulate_bwd(q, k, v, o, do, lse, **{**kw, **off})
        assert max(_rel(g, w) for g, w in zip(got, want)) > 1e-2, off


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
