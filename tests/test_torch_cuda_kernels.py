"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.

Every test that launches a kernel needs an NVIDIA GPU and ``nvcc``;
without a CUDA device each one skips (decided inside the ``cuda``
fixture, never at import).  The numpy mirrors of the monitor kernels'
shared-memory staging read only ``monitor.cu``'s constants and run
anywhere.  On a machine with the card run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

This file imports no JAX: the card's machine has none.
"""

import re

import numpy as np
import pytest
import torch

from repro_torch.core.monitor import (MonitorConfig, fleet_monitor_init,
                                      run_monitor_fleet)
from repro_torch.kernels.attention import kernel as AK
from repro_torch.kernels.attention import ops as AO
from repro_torch.kernels.attention.ref import (attention_bwd_ref,
                                               attention_lse_ref,
                                               attention_ref)
from repro_torch.kernels.monitor import kernel as K
from repro_torch.kernels.monitor import ops as MO
from repro_torch.kernels.monitor.ref import (batched_monitor_ref,
                                             carry_of_state,
                                             monitor_fleet_ref, window_carry)
from repro_torch.kernels.ssd import kernel as SK
from repro_torch.kernels.ssd import ops as SO
from repro_torch.kernels.ssd.ref import (ssd_chunk_batched_ref,
                                         ssd_chunk_bwd_ref, ssd_dA_scale)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    K.build()
    AK.build()
    AK.build_bwd()
    SK.build()
    SK.build_bwd()
    return torch.device("cuda")


def _noisy_streams(Q, T, seed, p_block=0.06):
    rng = np.random.default_rng(seed)
    base = rng.uniform(100, 400, (Q, 1))
    tc = rng.poisson(base, (Q, T)).astype(np.float32)
    blocked = rng.random((Q, T)) < p_block
    return tc, blocked


@pytest.mark.parametrize("q,w", [(8, 16), (100, 32), (256, 64), (37, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_monitor_kernel_matches_ref(cuda, q, w, dtype):
    rng = np.random.default_rng(q * w)
    win = torch.as_tensor(rng.uniform(0, 500, (q, w)).astype(np.float32),
                          device=cuda).to(dtype)
    before = K.batched_monitor.launches
    qk, muk, sdk = K.batched_monitor(win)
    torch.cuda.synchronize()
    assert K.batched_monitor.launches == before + 1
    qr, mur, sdr = batched_monitor_ref(win)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b in ((qk, qr), (muk, mur), (sdk, sdr)):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=tol, atol=tol * 500)


@pytest.mark.parametrize("cfg", [MonitorConfig(),
                                 MonitorConfig(sigma_mode="stderr"),
                                 MonitorConfig.paper_faithful()],
                         ids=["default", "stderr", "paper"])
def test_monitor_fleet_kernel_matches_ref(cuda, cfg):
    """Full mode, blocked samples, three chunks: the kernel's planes and
    state against the plain version on the same card.  The plain version
    fixes every reduction order and divides truly, and the kernel repeats
    it without fused multiply-adds, so they agree bit for bit."""
    Q, T = 1000, 600
    tc, blocked = _noisy_streams(Q, T, seed=11)
    before = K.monitor_fleet.launches
    st_k, out_k = run_monitor_fleet(cfg, tc, blocked, chunk_t=256,
                                    impl="cuda", device=cuda)
    torch.cuda.synchronize()
    assert K.monitor_fleet.launches == before + 3
    st_r, out_r = run_monitor_fleet(cfg, tc, blocked, chunk_t=256,
                                    impl="scan", device=cuda)
    for a, b in zip(tuple(out_k) + tuple(st_k), tuple(out_r) + tuple(st_r)):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


def test_monitor_fleet_state_mode_and_donation(cuda):
    """State mode equals full mode's state; a donated state is updated
    in place, a lent one is left untouched."""
    cfg = MonitorConfig()
    Q, T = 513, 300
    tc, blocked = _noisy_streams(Q, T, seed=4)
    st_full, _ = run_monitor_fleet(cfg, tc, blocked, chunk_t=100,
                                   mode="full", device=cuda)
    st0 = fleet_monitor_init(cfg, Q, device=cuda)
    st_state, out = run_monitor_fleet(cfg, tc, blocked, chunk_t=100,
                                      mode="state", state=st0, device=cuda)
    assert out is None
    assert int(st0.s_fill.sum()) == 0            # lent state untouched
    for a, b in zip(st_full, st_state):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
    st1 = fleet_monitor_init(cfg, Q, device=cuda)
    st_don, _ = run_monitor_fleet(cfg, tc, blocked, chunk_t=100,
                                  mode="state", state=st1, donate=True,
                                  pad_q=False, device=cuda)
    assert st_don.win.data_ptr() == st1.win.data_ptr()
    np.testing.assert_array_equal(st_don.epoch.cpu().numpy(),
                                  st_state.epoch.cpu().numpy())


@pytest.mark.parametrize("window,conv_window,radius",
                         [(16, 16, 2), (64, 16, 2), (32, 8, 2), (32, 32, 2),
                          (32, 16, 1), (32, 16, 3)])
def test_monitor_fleet_kernel_other_shapes(cuda, window, conv_window,
                                           radius):
    """Every other instantiated (window, conv_window, gauss_radius)
    agrees bit for bit with the plain version in full mode."""
    cfg = MonitorConfig(window=window, conv_window=conv_window,
                        gauss_radius=radius, min_q_samples=16)
    tc, blocked = _noisy_streams(300, 400, seed=window + conv_window)
    _, out_k = run_monitor_fleet(cfg, tc, blocked, chunk_t=200,
                                 impl="cuda", device=cuda)
    _, out_r = run_monitor_fleet(cfg, tc, blocked, chunk_t=200,
                                 impl="scan", device=cuda)
    assert int(out_r.epoch[:, -1].sum()) > 0
    for a, b in zip(out_k, out_r):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


# -- the monitor kernels' shared-memory staging --------------------------------

_CU = K.SOURCE.read_text()


def _define(name):
    return int(re.search(rf"#define {name} (\d+)", _CU).group(1))


THREADS, TC = _define("THREADS"), _define("TC")
SMEM_MAX, ROWS_CAP = _define("SMEM_MAX"), _define("ROWS_CAP_BYTES")
FLEET_SHAPES = [tuple(int(v) for v in m) for m in
                re.findall(r"X\((\d+), (\d+), (\d+)\)", _CU)]
BATCHED_WINDOWS = (16, 32, 64)      # compile-time instances, 5 taps


def _row_stride(w, size):
    """row_stride<T>(w): elements of an odd number of 4-byte words."""
    return ((((size * w + 3) // 4) | 1) * 4) // size


def _stage_rows(addr, n, w, stride, size):
    """stage_rows<T>() in numpy: each element's shared-memory slot, and
    the 16-byte load of the vector part that brings it (-1 for the
    elements before the first 16-byte boundary and after the last whole
    vector, which go one at a time)."""
    v = 16 // size
    head = ((16 - addr % 16) % 16) // size
    if addr % size or head > n:
        head = n
    nvec = (n - head) // v
    i = np.arange(n)
    vec = np.full(n, -1)
    body = slice(head, head + nvec * v)
    vec[body] = (i[body] - head) // v
    return (i // w) * stride + i % w, vec, head


def _batched_rows(w, size, ntaps=5):
    """Rows a CTA of launch_batched<>() takes."""
    if ntaps == 5 and w in BATCHED_WINDOWS:
        return THREADS
    rows = min(ROWS_CAP // (_row_stride(w, size) * size), THREADS)
    return max(rows - rows % 32 if rows >= 32 else rows, 1)


def _fleet_smem_bytes(w, cw):
    """fleet_smem_floats<W, CW>() * 4."""
    hist = THREADS * (2 * _row_stride(cw, 4) + _row_stride(2, 4))
    return 4 * (THREADS * _row_stride(w, 4) + max(hist, TC * (THREADS + 1)))


@pytest.mark.parametrize("q,w,size,offset", [
    (1, 32, 4, 0), (37, 32, 4, 0), (200001, 32, 4, 0), (300, 5, 4, 0),
    (300, 31, 4, 4), (300, 33, 2, 2), (129, 64, 2, 0), (257, 128, 4, 0),
    (257, 16, 4, 8), (5, 2, 4, 0), (129, 16, 4, 0)])
def test_staging_offsets_mirror(q, w, size, offset):
    """CTA row blocks at a ragged Q cover the rows once, in order; each
    block's run of bytes reaches shared memory row by row at an odd word
    stride, through 16-byte loads of neighbouring addresses, and thread
    r's reads of its row fall in 32 different banks across a warp."""
    rows_per_cta = _batched_rows(w, size)
    stride = _row_stride(w, size)
    assert (stride * size // 4) % 2 == 1 and stride >= w
    assert rows_per_cta * stride * size <= SMEM_MAX
    covered = 0
    for q0 in range(0, q, rows_per_cta):
        rows = min(rows_per_cta, q - q0)
        addr = offset + q0 * w * size
        slot, vec, head = _stage_rows(addr, rows * w, w, stride, size)
        assert len(np.unique(slot)) == rows * w
        r, k = np.divmod(np.arange(rows * w), w)
        np.testing.assert_array_equal(slot, r * stride + k)
        loads = vec[vec >= 0]
        if loads.size:                  # whole 16-byte vectors, in turn
            starts = addr + (head + np.unique(loads) * (16 // size)) * size
            assert (starts % 16 == 0).all()
            np.testing.assert_array_equal(np.diff(starts), 16)
        assert (vec < 0).sum() < 2 * (16 // size)
        covered += rows
        if q0 > 3 * rows_per_cta:       # the rest repeat the pattern
            covered = q
            break
    assert covered == q
    warp = np.arange(min(32, rows_per_cta))
    for col in range(w):
        banks = ((warp * stride + col) * size // 4) % 32
        assert len(np.unique(banks)) == len(warp)


@pytest.mark.parametrize("time_major", [True, False])
@pytest.mark.parametrize("rows,tc", [(THREADS, TC), (37, TC), (THREADS, 7),
                                     (1, 1)])
def test_tile_staging_mirror(time_major, rows, tc):
    """stage_tile<>() in numpy: every (step, queue) of the block lands
    once at s[tt * (THREADS + 1) + r]; a warp's 32 loads are 32
    neighbouring floats of the tile in either layout, and its 32 stores
    hit 32 different banks."""
    ld, q0, t0 = 1000, 3 * THREADS, 64
    i = np.arange(TC * THREADS)
    if time_major:
        tt, r = np.divmod(i, THREADS)
        addr = (t0 + tt) * ld + q0 + r
    else:
        r, tt = np.divmod(i, TC)
        addr = (q0 + r) * ld + t0 + tt
    live = (r < rows) & (tt < tc)
    slot = tt * (THREADS + 1) + r
    assert live.sum() == rows * tc
    assert len(np.unique(slot[live])) == rows * tc
    for w0 in range(0, i.size, 32):
        sel = live[w0:w0 + 32]
        if sel.sum() < 2:
            continue
        a, sl = addr[w0:w0 + 32][sel], slot[w0:w0 + 32][sel]
        np.testing.assert_array_equal(np.diff(a), 1)
        assert len(np.unique(sl % 32)) == sel.sum()


_BWD = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);",
                                          AK.SOURCE_BWD.read_text())}


def _bwd_padded(hd):
    """tc::padded: the head dims the tiles hold (128 at hd 112)."""
    return hd if hd <= 64 else -(-hd // 64) * 64


def _bwd_smem_bytes(hd, nwg, stages, split=None, xtiles=0):
    """tc::Geo<HD, ST, SPLIT, NSCR>::SMEM: 1024 bytes of alignment slack,
    two resident tiles of 64 NWG rows (64 where the warpgroups split the
    columns: above 128 padded head dims by default), per stage two
    streamed 64-row tiles and 64 lse and 64 D floats, a split CTA's
    ``xtiles`` 64 x 64 bf16 exchange tiles (P^T and dS^T double-buffered
    in (a), dS in (b)), and the mbarriers; tiles of the padded width."""
    hdp = _bwd_padded(hd)
    split = hdp > 128 if split is None else split
    tile, res = 64 * hdp * 2, (64 if split else 64 * nwg) * hdp * 2
    return (1024 + 2 * res + stages * (2 * tile + 2 * 64 * 4)
            + (xtiles * 64 * 64 * 2 if split else 0)
            + 8 * (2 * stages + 2))


def _bwd_instance_smem(hd):
    """The largest of (a) without and with the softcap/window (which
    splits the columns from 128 padded head dims on; four exchange tiles
    when split) and (b) (two stages at hd 256; two exchange tiles)."""
    nwg, hdp = _BWD["NWG"], _bwd_padded(hd)
    return max(_bwd_smem_bytes(hd, nwg, _BWD["DKDV_STAGES"], xtiles=4),
               _bwd_smem_bytes(hd, nwg, _BWD["DKDV_STAGES"],
                               split=hdp >= 128, xtiles=4),
               _bwd_smem_bytes(hd, nwg, 2 if hd > 128 else _BWD["DQ_STAGES"],
                               xtiles=2))


def test_bwd_hd256_shared_memory_is_the_documented_layout():
    """At hd 256 the split (a) holds its two resident and two streamed
    stages (198 704 bytes before this design) plus four 8 KiB exchange
    tiles: 231 472 of the 232 448 bytes; (b) two: 215 088."""
    nwg = _BWD["NWG"]
    assert _bwd_smem_bytes(256, nwg, _BWD["DKDV_STAGES"]) == 198704
    assert _bwd_smem_bytes(256, nwg, _BWD["DKDV_STAGES"], xtiles=4) == \
        231472 <= SMEM_MAX
    assert _bwd_smem_bytes(256, nwg, 2, xtiles=2) == 215088


_BWD_SRC = AK.SOURCE_BWD.read_text()


def _bwd_regs(cw):
    """tc::producer_regs / consumer_regs: (producer, consumer) registers
    a thread after setmaxnreg in (a), read from the source."""
    p = re.search(r"return CW \? (\d+) : PRODUCER_REGS;", _BWD_SRC)
    c = re.search(r"return CW \? (\d+) : CONSUMER_REGS;", _BWD_SRC)
    return ((int(p.group(1)), int(c.group(1))) if cw else
            (_BWD["PRODUCER_REGS"], _BWD["CONSUMER_REGS"]))


@pytest.mark.parametrize("cw", [False, True])
def test_bwd_register_balance(cw):
    """384 threads a CTA at 168 registers fill the SM's 65 536; the
    producer warpgroup's setmaxnreg.dec frees at least what the two
    consumer warpgroups' setmaxnreg.inc take, in multiples of 8 within
    24..256."""
    nwg = _BWD["NWG"]
    prod, cons = _bwd_regs(cw)
    assert 168 * 128 * (nwg + 1) <= 65536
    assert (168 - prod) * 128 >= (cons - 168) * 128 * nwg
    assert all(r % 8 == 0 and 24 <= r <= 256 for r in (prod, cons))


_FWD = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);",
                                          AK.SOURCE.read_text())}


def _fwd_smem_bytes(hd):
    """tc::Geo<HD>::SMEM of the forward: 1024 bytes of alignment slack, a
    64-row Q tile, STAGES K and V tiles of 64 rows, the 4 STAGES + 1
    mbarriers; tiles of the padded width (128 at hd 112)."""
    hdp = _bwd_padded(hd)
    tile = 64 * hdp * 2
    return 1024 + tile + 2 * _FWD["STAGES"] * tile + 8 * (
        4 * _FWD["STAGES"] + 1)


@pytest.mark.parametrize("hd", AK.HEAD_DIMS)
def test_fwd_geometry_fits_the_sm(hd):
    """The bf16 forward's CTA (a consumer warpgroup and a producer warp,
    tc::NT) fits the SM at every head dim: two CTAs an SM up to 128
    padded head dims at <= 168 registers a thread, one at hd 256 (255
    registers), within 232 448 bytes and 65 536 registers."""
    assert (_FWD["BQ"], _FWD["BK"], _FWD["NT"]) == (64, 64, 160)
    ctas = 2 if _bwd_padded(hd) <= 128 else 1
    regs = 168 if ctas == 2 else 255
    assert _fwd_smem_bytes(hd) * ctas <= SMEM_MAX
    assert ctas * _FWD["NT"] * regs <= 65536


def test_fwd_shared_memory_mirror_matches_the_library(cuda):
    for hd in AK.HEAD_DIMS:
        assert AK.shared_memory_bytes(hd, torch.bfloat16) == \
            _fwd_smem_bytes(hd)


def _bwd_f32_smem_bytes(hd):
    """simt::Geo<HD>::SMEM: four (BR, hd + 1) float tiles, two (BR, BR +
    1) and 2 BR floats, BR = 64 rows (32 at hd 256)."""
    br = 32 if hd > 128 else 64
    return (4 * br * (hd + 1) + 2 * br * (br + 1) + 2 * br) * 4


@pytest.mark.parametrize("hd", AK.HEAD_DIMS)
def test_bwd_shared_memory_fits_every_instance(hd):
    """Both bf16 backward kernels fit a CTA's 232 448 bytes at every head
    dim."""
    assert _bwd_instance_smem(hd) <= SMEM_MAX == 232448


@pytest.mark.parametrize("hd", AK.HEAD_DIMS)
def test_bwd_f32_shared_memory_fits_every_instance(hd):
    """The float32 backward kernels fit at every head dim: 32-row blocks
    at hd 256, where 64 rows would take 296 960 bytes."""
    assert _bwd_f32_smem_bytes(hd) <= SMEM_MAX
    if hd == 256:
        assert (4 * 64 * 257 + 2 * 64 * 65 + 128) * 4 == 296960 > SMEM_MAX


def test_bwd_shared_memory_mirror_matches_the_library(cuda):
    for hd in AK.HEAD_DIMS:
        assert AK.shared_memory_bytes_bwd(hd, torch.bfloat16) == \
            _bwd_instance_smem(hd)
        assert AK.shared_memory_bytes_bwd(hd, torch.float32) == \
            _bwd_f32_smem_bytes(hd)


def test_fleet_shared_memory_fits_every_instance():
    """Each instantiated (W, CW, R) fits a CTA's shared memory, and the
    default config's CTA leaves room for several on an SM."""
    assert (32, 16, 2) in FLEET_SHAPES and len(FLEET_SHAPES) == 7
    for w, cw, _ in FLEET_SHAPES:
        assert _fleet_smem_bytes(w, cw) <= SMEM_MAX
    assert _fleet_smem_bytes(32, 16) <= 48 * 1024


def test_fleet_shared_memory_mirror_matches_the_library(cuda):
    for w, cw, r in FLEET_SHAPES:
        cfg = MonitorConfig(window=w, conv_window=cw, gauss_radius=r)
        assert K.fleet_shared_memory_bytes(cfg) == _fleet_smem_bytes(w, cw)
    assert K.fleet_shared_memory_bytes(MonitorConfig(window=24)) == 0


@pytest.mark.parametrize("q", [1, 37, 200001])
@pytest.mark.parametrize("w", [5, 16, 31, 32, 33, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_monitor_ragged_rows(cuda, q, w, dtype):
    """Q off the CTA's rows and every kind of window: the compile-time
    instances (16, 32, 64) and the runtime one, f32 and bf16, at the
    JAX package's tolerances."""
    rng = np.random.default_rng(q + w)
    win = torch.as_tensor(rng.uniform(0, 500, (q, w)).astype(np.float32),
                          device=cuda).to(dtype)
    got = K.batched_monitor(win)
    want = batched_monitor_ref(win)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b in zip(got, want):
        assert a.shape == (q,)
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=tol, atol=tol * 500)


def _fleet_tile(cfg, Q, T, seed, device):
    """A mid-stream state (windows full, epochs past) and the next tile,
    compacted in both layouts."""
    tc, blocked = _noisy_streams(Q, 3 * T + 64, seed)
    state, _ = run_monitor_fleet(cfg, tc[:, :-T], blocked[:, :-T],
                                 chunk_t=T, impl="scan", mode="state",
                                 device=device)
    tile = torch.as_tensor(tc[:, -T:], device=device)
    blk = torch.as_tensor(blocked[:, -T:], device=device)
    rm = MO._compact(tile, blk)
    tm = MO._compact(tile.T.contiguous().T, blk.T.contiguous().T)
    assert tm[0].stride(0) == 1 and rm[0].stride(1) == 1
    return state, rm, tm


@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("T", [32, 256])
@pytest.mark.parametrize("window,conv_window,radius", FLEET_SHAPES)
def test_monitor_fleet_time_major_tile_is_bit_equal(cuda, window,
                                                    conv_window, radius, T,
                                                    full):
    """The kernel on the time-major tile equals its launch on the
    row-major one and the plain version, bit for bit, planes and state,
    at an odd Q, for every instance."""
    cfg = MonitorConfig(window=window, conv_window=conv_window,
                        gauss_radius=radius, min_q_samples=16)
    state, (comp_r, m, _), (comp_t, m_t, _) = _fleet_tile(
        cfg, 301, T, seed=window + T, device=cuda)
    assert torch.equal(m, m_t)
    st_t = type(state)(*(a.clone() for a in state))
    st_r = type(state)(*(a.clone() for a in state))
    before = K.monitor_fleet.launches
    out_t = K.monitor_fleet(cfg, st_t, comp_t, m_t, full=full)
    out_r = K.monitor_fleet(cfg, st_r, comp_r, m, full=full)
    assert K.monitor_fleet.launches == before + 2
    carry, cols = monitor_fleet_ref(cfg, state, comp_r, m)
    win = window_carry(state.win, comp_r, m)
    torch.cuda.synchronize()
    assert int(state.epoch.sum()) > 0           # a mid-stream state
    for a, b in zip(st_t, st_r):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
    want = (win,) + tuple(carry)
    got = (st_t.win,) + tuple(carry_of_state(st_t))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
    if full:
        for a, b, c in zip(out_t, out_r, cols):
            np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
            np.testing.assert_array_equal(a.cpu().numpy(), c.cpu().numpy())
    else:
        assert out_t is None and out_r is None


def test_cuda_tensor_never_falls_back(cuda):
    """A shape the kernel has no instance for raises on the card."""
    cfg = MonitorConfig(window=24)
    with pytest.raises(NotImplementedError):
        run_monitor_fleet(cfg, np.ones((4, 64), np.float32), device=cuda)


def _qkv(shape, seed, dtype, device, T=None):
    B, S, H, K_, hd = shape
    T = S if T is None else T
    rng = np.random.default_rng(seed)
    mk = lambda *sh: torch.as_tensor(  # noqa: E731
        rng.standard_normal(sh).astype(np.float32), device=device).to(dtype)
    return mk(B, S, H, hd), mk(B, T, K_, hd), mk(B, T, K_, hd)


@pytest.mark.parametrize("shape", [(1, 128, 2, 2, 32), (2, 256, 4, 2, 32),
                                   (1, 256, 8, 8, 64), (2, 100, 4, 1, 16),
                                   (1, 77, 8, 2, 128), (3, 1, 4, 2, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_matches_ref_f32(cuda, shape, causal):
    """f32 inputs: the kernel against the plain version at the JAX
    package's flash-attention tolerance (2e-4), tails included."""
    q, k, v = _qkv(shape, sum(shape), torch.float32, cuda)
    before = AK.flash_attention.launches
    out = AK.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert AK.flash_attention.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == q.shape
    ref = attention_ref(q, k, v, causal=causal)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("shape,T", [((8, 1000, 16, 8, 128), None),
                                     ((2, 64, 4, 2, 64), 200),
                                     ((2, 200, 4, 2, 64), 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_matches_ref_bf16(cuda, shape, T, causal):
    """bf16 inputs (the serving path's, at its shape with a masked tail,
    and S != T): the same bf16 values on both sides, so only the
    summation order differs (1e-3)."""
    q, k, v = _qkv(shape, 7, torch.bfloat16, cuda, T=T)
    out = AK.flash_attention(q, k, v, causal=causal, scale=0.1)
    ref = attention_ref(q, k, v, causal=causal, scale=0.1)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-3, atol=1e-3)


def _launch_once(q, k, v, **kw):
    before = AK.flash_attention.launches
    out = AK.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert AK.flash_attention.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == q.shape
    assert bool(torch.isfinite(out).all())
    return out


def _close_bf16(out, ref):
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("hd", [16, 32, 64, 112, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_every_head_dim(cuda, hd, causal):
    """The tensor-core kernel at each head dim: the 32-, 64- and 128-byte
    swizzles, one, two and four panels a row, and hd 112 on the 128-wide
    geometry with zero-filled columns (1e-3)."""
    q, k, v = _qkv((2, 300, 4, 2, hd), hd, torch.bfloat16, cuda)
    _close_bf16(_launch_once(q, k, v, causal=causal),
                attention_ref(q, k, v, causal=causal))


@pytest.mark.parametrize("S,T", [(1, 1), (77, 77), (1000, 1000),
                                 (1341, 1341), (77, 1341), (1341, 77),
                                 (1, 1000), (1000, 1)])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_ragged_lengths(cuda, S, T, group, causal):
    """S and T that no 128-row tile divides, S < T and S > T, GQA groups
    of 1, 2 and 4 at the path's head dim: rows past S or T arrive from
    the tensor maps as zeros and are masked or dropped (1e-3)."""
    q, k, v = _qkv((1, S, 2 * group, 2, 128), S + T + group,
                   torch.bfloat16, cuda, T=T)
    _close_bf16(_launch_once(q, k, v, causal=causal),
                attention_ref(q, k, v, causal=causal))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_large_scores(cuda, causal):
    """q x 4 at scale 1: scores in the hundreds, whose row maximum lies
    past the first tile for most rows, so the running max moves between
    tiles and the rescale of the accumulator and the sum is exercised."""
    q, k, v = _qkv((2, 1000, 8, 4, 128), 3, torch.bfloat16, cuda)
    q = (q.float() * 4).to(torch.bfloat16)
    s = torch.einsum("sh,th->st", q[0, :, 0].float(), k[0, :, 0].float())
    if causal:
        s = s.masked_fill(torch.ones_like(s, dtype=torch.bool).triu(1),
                          float("-inf"))
    assert float((s[256:].argmax(-1) >= 128).float().mean()) > 0.5
    assert float(s.abs().max()) > 100
    _close_bf16(_launch_once(q, k, v, causal=causal, scale=1.0),
                attention_ref(q, k, v, causal=causal, scale=1.0))


def test_flash_attention_bf16_first_rows_of_causal_blocks(cuda):
    """Rows 0-7 of every 128-row causal block at the path's shape, where a
    row sums the fewest keys of its tiles.  In the first block a P
    rounded to bf16 alone (the plain version with its weights so
    rounded) misses 1e-3; the kernel's split P holds it."""
    shape = (8, 1024, 16, 8, 128)
    B, S, H, K_, hd = shape
    q, k, v = _qkv(shape, 5, torch.bfloat16, cuda)
    out = _launch_once(q, k, v, causal=True)
    ref = attention_ref(q, k, v, causal=True)
    rows = [b0 + r for b0 in range(0, S, 128) for r in range(8)]
    _close_bf16(out[:, rows], ref[:, rows])
    # the control: unnormalised weights rounded to bf16, as one bf16 P.V
    # would take them
    qg = q.reshape(B, S, K_, H // K_, hd).float()
    s = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) * hd ** -0.5
    s = s.masked_fill(torch.ones(S, S, dtype=torch.bool, device=cuda)
                      .triu(1), float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p_bf16 = p.to(torch.bfloat16).float() / p.sum(-1, keepdim=True)
    ctrl = torch.einsum("bkgst,btkh->bskgh", p_bf16, v.float()).reshape(
        B, S, H, hd)
    first = (ctrl[:, :8] - ref[:, :8]).abs() > 1e-3 + 1e-3 * ref[:, :8].abs()
    assert bool(first.any())


def test_flash_attention_cuda_launches_or_raises(cuda):
    """A CUDA tensor launches the kernel or raises: never the plain
    version."""
    q, k, v = _qkv((1, 64, 2, 1, 32), 1, torch.float32, cuda)
    before = AK.flash_attention.launches
    AK.flash_attention(q, k, v)
    assert AK.flash_attention.launches == before + 1
    with pytest.raises(TypeError):
        AK.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        AK.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                           k, v)
    with pytest.raises(NotImplementedError):
        q48, k48, v48 = _qkv((1, 64, 2, 1, 48), 1, torch.float32, cuda)
        AK.flash_attention(q48, k48, v48)
    assert AK.flash_attention.launches == before + 1


@pytest.mark.parametrize("hd", [112, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("softcap,window", [(None, 0), (50.0, 0), (None, 100),
                                            (30.0, 77)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_softcap_and_window(cuda, hd, dtype, softcap, window,
                                            causal):
    """zamba2's hd 112 and gemma2's hd 256, each with and without an
    attention-logit softcap and a sliding window, against the plain
    version (1e-3 bf16, 2e-4 f32), q x 4 so that the cap bends the
    scores; the lse against ``attention_lse_ref``; the window's and the
    cap's absence would miss the gate."""
    tol = 1e-3 if dtype == torch.bfloat16 else 2e-4
    q, k, v = _qkv((2, 300, 4, 2, hd), hd + window, dtype, cuda)
    q = (q.float() * 4).to(dtype)
    kw = dict(causal=causal, softcap=softcap, window=window)
    out, lse = AK.flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    ref = attention_ref(q, k, v, **kw)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(lse.cpu().numpy(),
                               attention_lse_ref(q, k, **kw).cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    for off in (dict(softcap=None), dict(window=0)):
        if {**kw, **off} != kw:
            miss = (attention_ref(q, k, v, **{**kw, **off}) - out).abs()
            assert float(miss.max()) > 10 * tol


@pytest.mark.parametrize("hd,T", [(112, None), (256, 77), (112, 333)])
def test_flash_attention_window_ragged(cuda, hd, T):
    """A window that starts mid-tile at S != T, causal, every row keeping
    a key (S < T + window: 121 rows over 77 keys, the last row with one
    key; 200 rows over 200 or 333): the first tile of each block is the
    one that holds q0 - window + 1, the left-edge tiles masked (1e-3)."""
    S = 200 if T is None or T >= 200 else T + 45 - 1
    q, k, v = _qkv((2, S, 4, 1, hd), 11, torch.bfloat16, cuda, T=T)
    kw = dict(causal=True, softcap=50.0, window=45)
    _close_bf16(_launch_once(q, k, v, **kw), attention_ref(q, k, v, **kw))


@pytest.mark.parametrize("hd", [112, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_rows_without_a_key_raise(cuda, hd, causal):
    """S >= T + window leaves rows with no key in the window (333 rows
    over 77 keys, window 40), where the reference gives the mean of v
    and the kernel would give 0: the wrapper raises before launching,
    and one row short of that (S = T + window - 1) launches and holds
    the plain version (1e-3)."""
    kw = dict(causal=causal, softcap=50.0, window=40)
    q, k, v = _qkv((2, 333, 4, 2, hd), 7, torch.bfloat16, cuda, T=77)
    before = AK.flash_attention.launches
    with pytest.raises(NotImplementedError, match="no key"):
        AK.flash_attention(q, k, v, **kw)
    assert AK.flash_attention.launches == before
    q = q[:, :77 + 40 - 1].contiguous()
    _close_bf16(_launch_once(q, k, v, **kw), attention_ref(q, k, v, **kw))


# (hd, shape (B,S,H,K,hd) with hd last, T or None, arguments, q
# multiplier): each instance this backward gained, through the op
NEW_BWD_INSTANCES = [
    ((2, 300, 8, 8, 112), None, dict(causal=True), 1.0),
    ((1, 333, 8, 4, 256), 300, dict(causal=True, softcap=50.0, window=100),
     8.0),
    ((1, 300, 8, 4, 256), None, dict(causal=True, softcap=50.0), 8.0),
    ((2, 300, 8, 4, 128), None, dict(causal=True, softcap=30.0), 4.0),
    ((2, 300, 8, 4, 128), None, dict(causal=True, window=70), 1.0),
    ((1, 250, 4, 2, 112), 300, dict(causal=True, softcap=50.0, window=45),
     4.0),
    ((1, 300, 4, 2, 32), 350, dict(causal=False, window=90), 1.0)]


@pytest.mark.parametrize("shape,T,kw,qmul", NEW_BWD_INSTANCES)
def test_flash_attention_fn_runs_every_new_backward_instance(cuda, shape,
                                                             T, kw, qmul):
    """hd 112 and 256, the softcap and the window through
    ``FlashAttentionFn`` on the card: one forward and one backward
    launch, the gradients against ``attention_bwd_ref`` under the
    forward's output (rel L2 1e-2, bf16)."""
    B, S, H, K_, hd = shape
    q, k, v = _qkv(shape, hd + S, torch.bfloat16, cuda, T=T)
    q = (q.float() * qmul).to(torch.bfloat16)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    counts = AK.launch_counts()
    out = AO.flash_attention(q, k, v, **kw)
    do = torch.randn_like(out)
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    now = AK.launch_counts()
    assert now["flash_attention"] == counts["flash_attention"] + 1
    assert now["flash_attention_bwd"] == counts["flash_attention_bwd"] + 1
    want = attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                             out.detach(), do, **kw)
    for g, w in zip(grads, want):
        assert g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all())
        assert _rel_l2(g, w) <= 1e-2


def test_flash_attention_fn_refuses_before_the_forward(cuda):
    """What the backward kernel does not take raises before the forward
    launches, naming ROADMAP.md: a window that leaves rows with no key
    (S >= T + window) and a head dim outside ``HEAD_DIMS``; one row short
    of the first (S = T + window - 1) runs."""
    for shape, T, kw in (((1, 200, 2, 1, 64), 77, dict(window=123)),
                         ((1, 64, 2, 1, 48), None, {})):
        q, k, v = _qkv(shape, 5, torch.bfloat16, cuda, T=T)
        before = AK.launch_counts()
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            AO.flash_attention(q.requires_grad_(), k, v, **kw)
        assert AK.launch_counts() == before
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            AK.require_bwd_instance(shape[-1], shape[1], T or shape[1],
                                    kw.get("window", 0))
    q, k, v = _qkv((1, 199, 2, 1, 64), 5, torch.bfloat16, cuda, T=77)
    out = AO.flash_attention(q.requires_grad_(), k, v, window=123)
    torch.autograd.grad(out, q, torch.ones_like(out))
    torch.cuda.synchronize()


def _rel_l2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


# (shape (B,S,H,K,hd), T or None, dtype, causal, scale, rel L2 tolerance):
# f32 at 1e-4 (the same arithmetic in another order), bf16 at 1e-2 (dO, P
# and dS rounded to bf16 for the products, against float32).  The bf16
# cases hold the tensor-core kernels at every head dim, GQA 1, 2 and 4,
# S != T both ways, S and T off the 64-row blocks, causal or not.
BWD_CASES = ([((2, 130, 4, 2, hd), None, torch.float32, c, None, 1e-4)
              for hd in (16, 32, 64, 128) for c in (True, False)]
             + [((1, 77, 4, 2, 32), 250, torch.float32, True, 0.2, 1e-4),
                ((1, 250, 4, 1, 64), 77, torch.float32, False, None, 1e-4),
                ((1, 1000, 8, 2, 64), None, torch.float32, True, None, 1e-4),
                ((2, 1000, 16, 8, 128), None, torch.bfloat16, True, None,
                 1e-2),
                ((1, 250, 8, 2, 128), 77, torch.bfloat16, False, 0.1, 1e-2),
                ((1, 77, 4, 4, 16), 250, torch.bfloat16, True, None, 1e-2)]
             + [((2, 130, 4, 2, hd), None, torch.bfloat16, c, None, 1e-2)
                for hd in (16, 32, 64, 128) for c in (True, False)]
             + [((1, 190, 4, 1, 128), 300, torch.bfloat16, True, None, 1e-2),
                ((1, 300, 8, 8, 64), 190, torch.bfloat16, True, None, 1e-2),
                ((2, 333, 4, 2, 128), 520, torch.bfloat16, False, None,
                 1e-2),
                ((2, 520, 4, 4, 32), 333, torch.bfloat16, True, 0.2, 1e-2),
                ((1, 200, 8, 2, 16), 77, torch.bfloat16, False, None, 1e-2),
                ((1, 100, 4, 4, 64), 700, torch.bfloat16, True, None,
                 1e-2)])


# hd 112 and 256, the softcap and the window, in both input types:
# (shape, T, dtype, causal, scale, tol, softcap, window); the softcap's
# cases scale q x 4 in the test, so that the scores bend
BWD_CASES_CW = ([((2, 130, 4, 2, hd), None, dt, c, None, tol, None, 0)
                 for hd in (112, 256) for c in (True, False)
                 for dt, tol in ((torch.float32, 1e-4),
                                 (torch.bfloat16, 1e-2))]
                + [((1, 333, 8, 2, 112), 190, torch.bfloat16, True, None,
                    1e-2, None, 0),
                   ((1, 300, 4, 1, 256), 350, torch.bfloat16, True, 0.1,
                    1e-2, 50.0, 100),
                   ((2, 250, 8, 4, 128), 300, torch.bfloat16, True, None,
                    1e-2, 30.0, 0),
                   ((2, 250, 8, 4, 128), 300, torch.float32, True, None,
                    1e-4, 30.0, 64),
                   ((1, 300, 4, 4, 64), 250, torch.bfloat16, False, None,
                    1e-2, None, 80),
                   ((1, 200, 4, 2, 16), 270, torch.bfloat16, True, None,
                    1e-2, 10.0, 33),
                   ((1, 200, 4, 2, 256), 150, torch.float32, True, None,
                    1e-4, 50.0, 60)])


@pytest.mark.parametrize(
    "shape,T,dtype,causal,scale,tol,softcap,window",
    [c + (None, 0) for c in BWD_CASES] + BWD_CASES_CW)
def test_flash_attention_bwd_kernel_matches_ref(cuda, shape, T, dtype,
                                                causal, scale, tol, softcap,
                                                window):
    """The backward kernel against ``attention_bwd_ref`` on the same o
    and dO, each output by relative L2; the forward's lse against
    ``attention_lse_ref`` and its output unchanged by asking for it."""
    B, S, H, K_, hd = shape
    q, k, v = _qkv(shape, S + hd, dtype, cuda, T=T)
    if softcap:
        q = (q.float() * 4).to(dtype)
    kw = dict(causal=causal, scale=scale, softcap=softcap, window=window)
    do = torch.randn((B, S, H, hd), device=cuda,
                     generator=torch.Generator(cuda).manual_seed(1))
    o, lse = AK.flash_attention(q, k, v, return_lse=True, **kw)
    assert torch.equal(o, AK.flash_attention(q, k, v, **kw))
    torch.testing.assert_close(lse, attention_lse_ref(q, k, **kw),
                               rtol=1e-5, atol=1e-4)
    before = AK.flash_attention_bwd.launches
    got = AK.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    assert AK.flash_attention_bwd.launches == before + 1
    want = attention_bwd_ref(q, k, v, o, do, **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert bool(torch.isfinite(g).all())
        assert _rel_l2(g, w) <= tol


@pytest.mark.parametrize("shape,T,kw", [
    ((2, 1000, 16, 8, 128), None, dict(causal=True)),
    ((1, 250, 8, 2, 64), 77, dict(causal=False)),
    ((1, 77, 4, 4, 16), 250, dict(causal=True)),
    ((1, 1000, 8, 8, 112), None, dict(causal=True)),
    ((1, 1000, 8, 4, 256), None, dict(causal=True, softcap=50.0,
                                      window=300)),
    ((2, 300, 8, 4, 128), 333, dict(causal=True, softcap=30.0, window=64))])
def test_flash_attention_bwd_bf16_is_deterministic(cuda, shape, T, kw):
    """No float atomics: two calls on the same inputs give equal bits."""
    B, S, H, K_, hd = shape
    q, k, v = _qkv(shape, 11, torch.bfloat16, cuda, T=T)
    do = torch.randn((B, S, H, hd), device=cuda,
                     generator=torch.Generator(cuda).manual_seed(2))
    o, lse = AK.flash_attention(q, k, v, return_lse=True, **kw)
    first = AK.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    again = AK.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_flash_attention_bwd_kernels_do_not_spill(cuda):
    """ptxas's report of the backward library: every kernel of every
    instance (prep, the tensor-core kernels with and without the
    softcap and the window, the float32 kernels) keeps everything in
    registers."""
    from pathlib import Path

    from repro_torch.kernels._build import ptxas_report
    rep = ptxas_report(Path(str(AK.build_bwd()) + ".log").read_text())
    assert len([r for r in rep if "wgmma" in r["kernel"]]) == 4 * len(
        AK.HEAD_DIMS)
    for r in rep:
        assert r["spill_stores"] == 0 and r["spill_loads"] == 0, r


def test_flash_attention_fwd_kernels_do_not_spill(cuda):
    """ptxas's report of the forward library: its tensor-core kernels
    (with and without the softcap and the window, every head dim) keep
    everything in registers."""
    from pathlib import Path

    from repro_torch.kernels._build import ptxas_report
    rep = [r for r in ptxas_report(Path(str(AK.build()) + ".log").read_text())
           if "wgmma" in r["kernel"]]
    assert len(rep) == 2 * len(AK.HEAD_DIMS)
    for r in rep:
        assert r["spill_stores"] == 0 and r["spill_loads"] == 0, r


def test_flash_attention_fn_on_the_card(cuda):
    """The op under grad: the forward kernel with its lse and the
    backward kernel, one launch each, gradients in the inputs' dtype and
    equal to calling the backward wrapper directly."""
    q, k, v = (t.requires_grad_() for t in _qkv(
        (2, 200, 8, 4, 128), 3, torch.bfloat16, cuda))
    counts = AK.launch_counts()
    out = AO.flash_attention(q, k, v)
    do = torch.randn_like(out)
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    now = AK.launch_counts()
    assert now["flash_attention"] == counts["flash_attention"] + 1
    assert now["flash_attention_bwd"] == counts["flash_attention_bwd"] + 1
    with torch.no_grad():
        o, lse = AK.flash_attention(q, k, v, return_lse=True)
        want = AK.flash_attention_bwd(q, k, v, o, do, lse)
    for g, w in zip(grads, want):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, w.to(torch.bfloat16))


def test_kernels_refuse_grad_outside_a_function(cuda):
    """On the card neither kernel cuts a gradient silently: with grad
    mode on and an input that requires grad, the flash wrapper and the
    SSD wrapper raise, each naming the autograd Function to go through
    (``FlashAttentionFn``, ``SSDChunkFn``)."""
    q, k, v = _qkv((1, 64, 2, 1, 32), 1, torch.float32, cuda)
    with pytest.raises(RuntimeError, match="FlashAttentionFn"):
        AK.flash_attention(q.requires_grad_(), k, v)
    with torch.no_grad():
        AK.flash_attention(q, k, v)
    x, dt, A, Bm, Cm = _ssd_inputs((1, 2, 16), 2, 16, 8, 0, cuda)
    with pytest.raises(RuntimeError, match="SSDChunkFn"):
        SK.ssd_chunk(x.requires_grad_(), dt, A, Bm, Cm)
    with torch.no_grad():
        SK.ssd_chunk(x, dt, A, Bm, Cm)


@pytest.mark.parametrize("B,c,Q,H,P,N", [
    (1, 4, 8, 2, 8, 8), (2, 3, 17, 3, 32, 16), (1, 2, 100, 9, 64, 64),
    (2, 1, 256, 5, 64, 128), (1, 1, 1, 2, 8, 8), (1, 2, 193, 17, 16, 128),
    (1, 3, 37, 3, 32, 12), (2, 1, 64, 11, 8, 4), (1, 1, 193, 3, 8, 4),
    (1, 1, 256, 9, 64, 64), (1, 2, 256, 3, 64, 128), (1, 2, 70, 3, 16, 196)])
def test_ssd_chunk_bwd_kernel_matches_ref(cuda, B, c, Q, H, P, N):
    """The backward kernel against ``ssd_chunk_bwd_ref`` with cotangents
    on y, state and decay: each gradient within 1e-4 of its slice's
    largest |plain| (dx and ddt per (b, c, h), dB and dC per (b, c)), dA
    within 1e-4 of the sum of its terms' magnitudes; two calls equal to
    the bit, one launch counted each."""
    ins = _ssd_inputs((B, c, Q), H, P, N, seed=B + c + Q + H, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(Q)
    cots = (torch.randn((B, c, Q, H, P), generator=g, device=cuda),
            torch.randn((B, c, H, P, N), generator=g, device=cuda),
            torch.randn((B, c, H), generator=g, device=cuda))
    before = SK.ssd_chunk_bwd.launches
    got = SK.ssd_chunk_bwd(*ins, *cots)
    again = SK.ssd_chunk_bwd(*ins, *cots)
    torch.cuda.synchronize()
    assert SK.ssd_chunk_bwd.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = ssd_chunk_bwd_ref(*ins, *cots)
    dA_scale = ssd_dA_scale(*ins, *cots)
    for (name, dims), gt, w in zip(
            (("dx", (2, 4)), ("ddt", (2,)), ("dA", None), ("dB", (2, 3)),
             ("dC", (2, 3))), got, want):
        assert bool(torch.isfinite(gt).all()), name
        scale = (dA_scale if dims is None
                 else w.abs().amax(dim=dims, keepdim=True))
        assert bool(((gt - w).abs() <= 1e-4 * scale.clamp_min(1e-30)).all()), \
            name


def test_ssd_chunk_bwd_kernels_do_not_spill(cuda):
    """ptxas's report of the backward library: no kernel of it spills,
    the tensor-core ``ssd_bwd_main`` at every head dim included."""
    from pathlib import Path

    from repro_torch.kernels._build import ptxas_report
    rep = ptxas_report(Path(str(SK.build_bwd()) + ".log").read_text())
    names = " ".join(r["kernel"] for r in rep)
    for kernel in ("ssd_bwd_cb", "ssd_bwd_main", "ssd_bwd_dcb", "ssd_bwd_dbc",
                   "ssd_bwd_finish", "ssd_bwd_da"):
        assert kernel in names, kernel
    assert sum("ssd_bwd_main" in r["kernel"] for r in rep) == len(
        SK.HEAD_DIMS)
    for r in rep:
        assert r["spill_stores"] == 0 and r["spill_loads"] == 0, r


def test_ssd_grad_goes_through_the_backward_kernel(cuda):
    """On the card a gradient through ``ssd_chunked(impl="kernel")``
    launches ``ssd_chunk_bwd`` once and agrees with autograd through the
    plain version (rel L2 1e-4)."""
    B, S, H, P, N = 2, 96, 4, 16, 8
    ins = _ssd_inputs((B, S), H, P, N, seed=3, device=cuda)
    grads = {}
    for impl in SO.IMPLS:
        leaves = [t.clone().requires_grad_() for t in ins]
        before = SK.ssd_chunk_bwd.launches
        y, h = SO.ssd_chunked(*leaves, 32, impl=impl)
        grads[impl] = torch.autograd.grad(y.square().sum() + h.sum(), leaves)
        assert SK.ssd_chunk_bwd.launches == before + (impl == "kernel")
    for gk, gp in zip(grads["kernel"], grads["plain"]):
        assert float((gk - gp).norm() / gp.norm()) <= 1e-4


def test_ssd_grad_of_a_plain_sum_goes_through_the_backward_kernel(cuda):
    """``y.sum()`` hands the Function a stride-0 cotangent: on the card
    it still reaches ``ssd_chunk_bwd`` once (no contiguity error) and
    agrees with autograd through the plain version (rel L2 1e-4)."""
    B, S, H, P, N = 2, 96, 4, 16, 8
    ins = _ssd_inputs((B, S), H, P, N, seed=4, device=cuda)
    grads = {}
    for impl in SO.IMPLS:
        leaves = [t.clone().requires_grad_() for t in ins]
        before = SK.ssd_chunk_bwd.launches
        y, _ = SO.ssd_chunked(*leaves, 32, impl=impl)
        grads[impl] = torch.autograd.grad(y.sum(), leaves)
        assert SK.ssd_chunk_bwd.launches == before + (impl == "kernel")
    for gk, gp in zip(grads["kernel"], grads["plain"]):
        assert float((gk - gp).norm() / gp.norm()) <= 1e-4


@pytest.mark.parametrize("placement", ["heads", "batch"])
def test_ssd_ops_run_on_local_shards_of_a_world_of_one(cuda, placement):
    """``models.ssm.ssd_chunked`` on DTensors over an NCCL world of one,
    under grad: the forward and backward kernels launch once each on the
    local shards, y and the final state keep the inputs' split, the
    gradients come back in the split's placements (its sums over what
    the shards split as partial sums: dB and dC under heads, dA under
    batch), and every output and gradient equals the unsharded op's to
    the bit."""
    import socket
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (Partial, Replicate, Shard,
                                          distribute_tensor)
    from repro_torch.models import ssm
    B, S, Q, H, P, N = 2, 128, 64, 4, 64, 32
    ins = _ssd_inputs((B, S), H, P, N, seed=5, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(6)
    wts = [torch.randn(s, generator=g, device=cuda)
           for s in ((B, S, H, P), (B, H, P, N))]

    def run(args, ws):
        for t in args:
            t.requires_grad_(True)
        before = dict(SK.launch_counts())
        outs = ssm.ssd_chunked(*args, Q)
        sum((o * w).sum() for o, w in zip(outs, ws)).backward()
        torch.cuda.synchronize()
        after = SK.launch_counts()
        assert after["ssd_chunk"] == before["ssd_chunk"] + 1
        assert after["ssd_chunk_bwd"] == before["ssd_chunk_bwd"] + 1
        return [o.detach() for o in outs], [t.grad for t in args]
    want, want_grads = run([t.clone() for t in ins], wts)
    dims = {"heads": {0: 2, 1: 2, 2: 0}, "batch": {0: 0, 1: 0, 3: 0, 4: 0}}
    out_pl = {"heads": ([Shard(2), Shard(1)],
                        [Shard(2), Shard(2), Shard(0), Partial(), Partial()]),
              "batch": ([Shard(0)] * 2,
                        [Shard(0), Shard(0), Partial(), Shard(0),
                         Shard(0)])}[placement]
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dev = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1, device_id=dev)
    try:
        mesh = init_device_mesh("cuda", (1,))
        dins = [distribute_tensor(t, mesh, [Shard(dims[placement][i])
                                            if i in dims[placement]
                                            else Replicate()])
                for i, t in enumerate(ins)]
        dws = [distribute_tensor(w, mesh, [pl])
               for w, pl in zip(wts, out_pl[0])]
        outs, grads = run(dins, dws)
        assert [o.placements[0] for o in outs] == out_pl[0]
        assert [t.placements[0] for t in grads] == out_pl[1]
        for got, w in zip(outs + grads, want + want_grads):
            assert torch.equal(got.full_tensor(), w)
    finally:
        dist.destroy_process_group()


def _ssd_inputs(lead, H, P, N, seed, device):
    """Drawn as the JAX package's SSD kernel test draws them: normal x,
    B and C; softplus-normal dt; A = -exp(normal)."""
    rng = np.random.default_rng(seed)
    mk = lambda a: torch.as_tensor(a.astype(np.float32),  # noqa: E731
                                   device=device)
    return (mk(rng.standard_normal(lead + (H, P))),
            mk(np.log1p(np.exp(rng.standard_normal(lead + (H,))))),
            mk(-np.exp(rng.standard_normal(H))),
            mk(rng.standard_normal(lead + (N,))),
            mk(rng.standard_normal(lead + (N,))))


def _ssd_close(got, want, tol=1e-4):
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("B,c,Q,H,P,N", [
    (1, 4, 8, 2, 8, 8), (2, 4, 16, 4, 8, 16), (2, 4, 32, 2, 16, 32),
    (2, 3, 37, 3, 32, 16), (1, 2, 100, 9, 64, 64), (2, 1, 256, 5, 64, 128),
    (1, 1, 1, 2, 8, 8), (1, 2, 193, 17, 16, 128), (1, 3, 37, 3, 32, 12),
    (2, 1, 193, 11, 64, 20)])
def test_ssd_chunk_kernel_matches_ref(cuda, B, c, Q, H, P, N):
    """The chunk kernel against its plain version (1e-4): the JAX test
    shapes' chunks, odd Q, Q and N not multiples of 8, ragged head groups
    (at P 16 and 64) and the path's P/N 64/128."""
    ins = _ssd_inputs((B, c, Q), H, P, N, seed=B + c + Q + H, device=cuda)
    before = SK.ssd_chunk.launches
    got = SK.ssd_chunk(*ins)
    torch.cuda.synchronize()
    assert SK.ssd_chunk.launches == before + 1
    assert [tuple(g.shape) for g in got] == [
        (B, c, Q, H, P), (B, c, H, P, N), (B, c, H)]
    _ssd_close(got, ssd_chunk_batched_ref(*ins))


@pytest.mark.parametrize("Q,P,N", [(256, 64, 128), (200, 32, 20)])
def test_ssd_chunk_kernel_steep_decay(cuda, Q, P, N):
    """dt near 0.1 and A near -16: acum falls by ~1.6 a row, so
    exp(acum_i - acum_j) above the diagonal overflows float32.  The
    kernel never evaluates it there: its outputs are finite and within
    1e-4 of the plain version, the decays underflow to 0 as there."""
    rng = np.random.default_rng(Q + P + N)
    lead, H = (2, 2, Q), 11
    mk = lambda a: torch.as_tensor(a.astype(np.float32),  # noqa: E731
                                   device=cuda)
    ins = (mk(rng.standard_normal(lead + (H, P))),
           mk(rng.uniform(0.09, 0.11, lead + (H,))),
           mk(-rng.uniform(15.0, 16.0, H)),
           mk(rng.standard_normal(lead + (N,))),
           mk(rng.standard_normal(lead + (N,))))
    got = SK.ssd_chunk(*ins)
    torch.cuda.synchronize()
    _ssd_close(got, ssd_chunk_batched_ref(*ins))


@pytest.mark.parametrize("shape", [(1, 32, 2, 8, 8), (2, 64, 4, 8, 16),
                                   (2, 128, 2, 16, 32)])
@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_ssd_chunked_kernel_matches_plain(cuda, shape, chunk):
    B, S, H, P, N = shape
    ins = _ssd_inputs((B, S), H, P, N, seed=S + chunk, device=cuda)
    _ssd_close(SO.ssd_chunked(*ins, chunk, impl="kernel"),
               SO.ssd_chunked(*ins, chunk, impl="plain"))


def test_ssd_chunked_kernel_carries_h0(cuda):
    x, dt, A, Bm, Cm = _ssd_inputs((1, 64), 2, 8, 16, seed=1, device=cuda)
    y_full, h_full = SO.ssd_chunked(x, dt, A, Bm, Cm, 16)
    _, h1 = SO.ssd_chunked(x[:, :32], dt[:, :32], A, Bm[:, :32],
                           Cm[:, :32], 16)
    y2, h2 = SO.ssd_chunked(x[:, 32:].contiguous(), dt[:, 32:].contiguous(),
                            A, Bm[:, 32:].contiguous(),
                            Cm[:, 32:].contiguous(), 16, h0=h1)
    _ssd_close((y2, h2), (y_full[:, 32:], h_full))


def test_ssd_chunk_cuda_launches_or_raises(cuda):
    """A CUDA tensor launches the kernel or raises: never the plain
    version.  bf16 is cast to float32 first; other dtypes, mixed devices
    and shapes without an instance raise."""
    ins = _ssd_inputs((1, 2, 16), 2, 16, 16, seed=3, device=cuda)
    before = SK.ssd_chunk.launches
    got = SK.ssd_chunk(*(t.bfloat16() for t in ins))
    assert SK.ssd_chunk.launches == before + 1
    _ssd_close(got, ssd_chunk_batched_ref(*(t.bfloat16() for t in ins)))
    with pytest.raises(TypeError):
        SK.ssd_chunk(*(t.half() for t in ins))
    with pytest.raises(ValueError):
        SK.ssd_chunk(ins[0], ins[1], ins[2].cpu(), ins[3], ins[4])
    with pytest.raises(ValueError):
        x = ins[0].transpose(3, 4).contiguous().transpose(3, 4)
        SK.ssd_chunk(x, *ins[1:])
    with pytest.raises(NotImplementedError):
        SK.ssd_chunk(*_ssd_inputs((1, 1, 8), 2, 24, 8, seed=4, device=cuda))
    with pytest.raises(NotImplementedError):
        SK.ssd_chunk(*_ssd_inputs((1, 1, 300), 2, 8, 8, seed=4,
                                  device=cuda))
    assert SK.ssd_chunk.launches == before + 1


# -- the encoder-decoder and MoE paths ----------------------------------------

@pytest.mark.parametrize("S,T,G", [(1, 1536, 1), (1, 37, 4), (3, 300, 2)])
def test_decode_scores_on_the_card_equal_the_float32_product(cuda, S, T, G):
    """``models.attention._f32_scores`` on bf16 card tensors (``bmm``
    with a float32 output, no float32 copy of k) against the float32
    product of the same bf16 values: the products are exact in float32,
    so only the summation order differs."""
    from repro_torch.models.attention import _f32_scores
    g = torch.Generator(device=cuda).manual_seed(S + T)
    K, hd = 4, 64
    q = torch.randn(2, S, K, G, hd, device=cuda, generator=g).bfloat16()
    k = torch.randn(2, T, K, hd, device=cuda, generator=g).bfloat16()
    got = _f32_scores(q, k)
    want = torch.einsum("bskgh,btkh->bkgst", q.float(), k.float())
    assert got.dtype == torch.float32 and got.shape == (2, K, G, S, T)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("arch", ["whisper-large-v3",
                                  "phi3.5-moe-42b-a6.6b"])
def test_smoke_models_on_the_card_match_plain_attention(cuda, arch):
    """The smoke enc-dec and MoE models on the card in float32: the
    prefill launches the flash kernel once an attention layer (Whisper:
    encoder, decoder self and cross) and its logits match the plain
    attention's; one decode step gives the same token."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    cfg = get_smoke_config(arch)
    model = build_model(cfg, torch.float32)
    plain = build_model(cfg, torch.float32, kernel_impl="plain")
    params = model.init_params(torch.Generator(device=cuda).manual_seed(0),
                               device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 9),
                                     device=cuda, generator=g)}
    n_attn = cfg.n_layers
    if cfg.is_encdec:
        batch["frames"] = torch.randn(2, cfg.encoder_seq, cfg.d_model,
                                      device=cuda, generator=g)
        n_attn = cfg.encoder_layers + 2 * cfg.n_layers
    with torch.inference_mode():
        before = AK.flash_attention.launches
        lk, ck = model.prefill(params, batch)
        assert AK.flash_attention.launches == before + n_attn
        lp, cp = plain.prefill(params, batch)
        torch.testing.assert_close(lk, lp, rtol=1e-4, atol=1e-4)
        cache = model.init_cache(2, 16, device=cuda)
        for n in cache:
            cache[n][:, :, :ck[n].shape[2]] = ck[n]
        cur = torch.argmax(lk[:, -1], -1).to(torch.int32)
        pos = torch.full((2,), 9, device=cuda)
        tk, _ = model.decode_step(params, cache, cur, pos)
        for n in cache:
            cache[n][:, :, :cp[n].shape[2]] = cp[n]
        tp, _ = plain.decode_step(params, cache, cur, pos)
    assert torch.equal(tk, tp)


# -- the control decision's CUDA graph ----------------------------------------

def test_control_decide_graph_equals_numpy_and_builds_once():
    """The ``"jit"`` form of ``control_decide`` on the card (one CUDA
    graph, replayed) against the numpy form over a random 40-tick drive
    with every leg live, SLO included: decisions equal, state to rtol
    1e-6; ragged fleets within one ``block_q`` build the graph once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decision's CUDA graph runs "
                    "only on the card")
    from repro_torch import control as CT
    dev = torch.device("cuda", 0)
    cfg = CT.ControlConfig(confirm_ticks=1, cooldown_ticks=5, block_q=16,
                           min_ready=4, slo_enabled=True, slo_fast_ticks=2,
                           slo_slow_ticks=4, max_replicas=16,
                           saturation_growth=1.5)
    q = 13
    rng = np.random.default_rng(3)
    st_n = CT.control_init(cfg, q, device="cpu")
    st_j = CT.control_init(cfg, q, device=dev)
    base = CT.control_decide_trace_count()
    fired = 0
    for t in range(40):
        ops = dict(lam=rng.uniform(0, 300, q), mu=rng.uniform(0, 300, q),
                   ready=rng.random(q) > 0.2,
                   replicas=rng.integers(1, 8, q),
                   caps=rng.integers(4, 256, q),
                   cv2=rng.uniform(0.1, 2, q), occupancy=rng.random(q),
                   saturated=rng.random(q) > 0.8,
                   stale=rng.random(q) > 0.8,
                   leg_rep=rng.random(q) > 0.2,
                   leg_buf=rng.random(q) > 0.2,
                   leg_adm=rng.random(q) > 0.2,
                   headroom=rng.uniform(1.0, 2.0, q),
                   max_replicas=rng.integers(2, 16, q),
                   slo_target=np.where(rng.random(q) > 0.3, 4e-3, np.nan),
                   over_frac=rng.random(q))
        st_n, dn = CT.control_decide(cfg, st_n, impl="numpy", **ops)
        st_j, dj = CT.control_decide(cfg, st_j, impl="jit", **ops)
        fired += int(dn.scale_mask.sum() + dn.resize_mask.sum())
        for name, a, b in zip(dn._fields, dn, dj):
            np.testing.assert_array_equal(b, a, err_msg=f"{t} {name}")
        for name, a, b in zip(st_n._fields, st_n, st_j):
            assert b.device == dev
            np.testing.assert_allclose(b.cpu().numpy(), a, rtol=1e-6,
                                       err_msg=f"{t} state {name}")
    assert fired
    assert CT.control_decide_trace_count() == base + 1
    for n in (3, 5, 9, 16, 2):           # ragged, one padded size
        CT.control_decide(cfg, CT.control_init(cfg, n, device=dev),
                          lam=np.full(n, 100.0), mu=np.full(n, 50.0),
                          ready=np.ones(n, bool), replicas=np.ones(n),
                          caps=np.full(n, 64), impl="jit")
    assert CT.control_decide_trace_count() == base + 1
