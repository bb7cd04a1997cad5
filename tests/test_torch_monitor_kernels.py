"""Parity of the port's fleet monitor (``repro_torch.kernels.monitor``)
with the JAX package, on the CPU.

On the CPU the kernel wrappers run their plain PyTorch versions; the
JAX side runs as its own tests run it (``impl="scan"``/``"rounds"``,
``run_monitor``, ``batched_monitor_pallas(interpret=True)``).  Inputs
come from numpy with a seed.  Tolerances are the JAX package's own:
epochs and convergence flags exact, q/q-bar/estimates to rtol 1e-4 and
atol 1e-3, the window stage to 1e-4 (f32) and 2e-2 (bf16).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import monitor as j_mon
from repro.kernels.monitor import ops as j_ops
from repro.kernels.monitor.kernel import batched_monitor_pallas
from repro_torch.core import monitor as t_mon
from repro_torch.kernels.monitor import kernel as t_kernel
from repro_torch.kernels.monitor import ops as t_ops
from repro_torch.kernels.monitor import ref as t_ref

# the test workers share the machine: keep PyTorch's CPU ops on one
# thread so these files do not starve the timing-sensitive suites
torch.set_num_threads(1)

CONFIGS = [{}, {"sigma_mode": "stderr"}, "paper"]
CFG_IDS = ["default", "stderr", "paper"]


def _cfgs(spec):
    if spec == "paper":
        return t_mon.MonitorConfig.paper_faithful(), \
            j_mon.MonitorConfig.paper_faithful()
    return t_mon.MonitorConfig(**spec), j_mon.MonitorConfig(**spec)


def _noisy_streams(Q=5, T=700, seed=0, p_block=0.06):
    rng = np.random.default_rng(seed)
    base = rng.uniform(100, 400, (Q, 1))
    tc = rng.poisson(base, (Q, T)).astype(np.float64)
    blocked = rng.random((Q, T)) < p_block
    return tc, blocked


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_outputs_match(out, ref):
    np.testing.assert_array_equal(_np(out.epoch), _np(ref.epoch))
    np.testing.assert_array_equal(_np(out.converged), _np(ref.converged))
    for name in ("q", "qbar", "estimate"):
        np.testing.assert_allclose(_np(getattr(out, name)),
                                   _np(getattr(ref, name)),
                                   rtol=1e-4, atol=1e-3)


# -- the per-tick window stage (batched_monitor) ------------------------------

@pytest.mark.parametrize("q,w", [(8, 16), (100, 32), (256, 64), (37, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batched_monitor_ref_matches_jax_kernel(q, w, dtype):
    rng = np.random.default_rng(q * w)
    win = rng.uniform(0, 500, (q, w)).astype(np.float32)
    j_win = jnp.asarray(win).astype(getattr(jnp, dtype))
    # the same (rounded) values on both sides
    t_win = torch.as_tensor(np.array(j_win.astype(jnp.float32))).to(
        getattr(torch, dtype))
    qp, mup, sdp = batched_monitor_pallas(j_win, interpret=True)
    before = t_kernel.batched_monitor.launches
    qr, mur, sdr = t_kernel.batched_monitor(t_win)   # CPU: plain version
    tol = 1e-4 if dtype == "float32" else 2e-2
    for a, b in ((qr, qp), (mur, mup), (sdr, sdp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol,
                                   atol=tol * 500)
    assert t_kernel.batched_monitor.launches == before   # no CPU launch


def test_fleet_monitor_step_matches_jax():
    rng = np.random.default_rng(2)
    Q, W = 6, 32
    win = rng.uniform(50, 150, (Q, W)).astype(np.float32)
    for spec in ({}, {"sigma_mode": "stderr"}):
        t_cfg, j_cfg = _cfgs(spec)
        ts = t_ops.fleet_step_init(t_cfg, Q, device="cpu")
        js = j_ops.fleet_step_init(j_cfg, Q)
        for _ in range(t_cfg.conv_window + 2):
            qt, ts, st = t_ops.fleet_monitor_step(torch.as_tensor(win), ts,
                                                  cfg=t_cfg)
            qj, js, sj = j_ops.fleet_monitor_step(jnp.asarray(win), js,
                                                  cfg=j_cfg)
            np.testing.assert_allclose(qt.numpy(), np.asarray(qj),
                                       rtol=1e-4)
            # the windows repeat, so sigma is rounding noise at the ulp
            # of q (~100 -> 7.6e-6): compare it on that absolute scale
            np.testing.assert_allclose(st.numpy(), np.asarray(sj),
                                       rtol=1e-4, atol=1e-4)
    bare = t_ops.fleet_monitor_step(
        torch.as_tensor(win), t_ops.fleet_step_init(t_cfg, Q,
                                                    device="cpu").welford)
    assert bare[2].shape == (Q,)
    np.testing.assert_allclose(
        t_ops.fleet_monitor_q(torch.as_tensor(win)).numpy(),
        np.asarray(j_ops.fleet_monitor_q(jnp.asarray(win))), rtol=1e-4)


# -- the fused fleet scan (monitor_fleet) --------------------------------------

@pytest.mark.parametrize("impl", ["cuda", "scan"])
@pytest.mark.parametrize("spec", CONFIGS, ids=CFG_IDS)
def test_fleet_matches_jax_outputs(spec, impl):
    """(Q, T) outputs are step-for-step those of the JAX package's
    vmap(run_monitor) and of its scan oracle."""
    t_cfg, j_cfg = _cfgs(spec)
    tc, blocked = _noisy_streams(Q=4, T=600, seed=3)
    ref = jax.vmap(lambda t, b: j_mon.run_monitor(j_cfg, t, b))(
        jnp.asarray(tc, jnp.float32), jnp.asarray(blocked))
    _, scan = j_mon.run_monitor_fleet(j_cfg, tc, blocked, chunk_t=200,
                                      impl="scan", block_q=8)
    st, out = t_mon.run_monitor_fleet(t_cfg, tc, blocked, chunk_t=200,
                                      impl=impl, block_q=8, device="cpu")
    _assert_outputs_match(out, ref)
    _assert_outputs_match(out, scan)
    np.testing.assert_array_equal(st.epoch.numpy(),
                                  np.asarray(ref.epoch[:, -1]))


def test_fleet_matches_host_monitor_per_epoch():
    """Estimates match the float64 oracle within rtol=1e-4 for every
    epoch, with epoch counts identical."""
    cfg = t_mon.MonitorConfig()
    tc, blocked = _noisy_streams()
    st, out = t_mon.run_monitor_fleet(cfg, tc, blocked, chunk_t=256,
                                      block_q=8, device="cpu")
    conv, est = out.converged.numpy(), out.estimate.numpy()
    total = 0
    for q in range(tc.shape[0]):
        hm = t_mon.HostMonitor(cfg)
        for t, b in zip(tc[q], blocked[q]):
            hm.update(float(t), bool(b))
        assert int(st.epoch[q]) == hm.epoch
        np.testing.assert_allclose(est[q][conv[q]], hm.estimates, rtol=1e-4)
        total += hm.epoch
    assert total >= 5      # resets exercised


@pytest.mark.parametrize("impl", ["cuda", "scan"])
def test_fleet_blocked_samples_are_discarded(impl):
    cfg = t_mon.MonitorConfig()
    Q, T = 3, 64
    tc = np.full((Q, T), 100.0)
    blocked = np.zeros((Q, T), bool)
    blocked[1] = True                    # queue 1 fully blocked
    st, out = t_mon.run_monitor_fleet(cfg, tc, blocked, chunk_t=32,
                                      impl=impl, block_q=8, device="cpu")
    assert int(st.s_fill[1]) == 0
    assert int(st.n_blocked[1]) == T
    assert int(st.n_total[1]) == T
    assert int(st.s_fill[0]) == cfg.window
    assert not bool(out.converged[1].any())


@pytest.mark.parametrize("impl", ["cuda", "scan"])
def test_fleet_state_carries_across_dispatches(impl):
    """Chunked dispatches agree exactly with one big dispatch, and with
    the JAX package's chunked scan."""
    t_cfg, j_cfg = _cfgs({})
    tc, blocked = _noisy_streams(Q=3, T=512, seed=9)
    st_a, out_a = t_mon.run_monitor_fleet(t_cfg, tc, blocked, chunk_t=512,
                                          impl=impl, block_q=8,
                                          device="cpu")
    st_b = t_mon.fleet_monitor_init(t_cfg, 3, device="cpu")
    st_j = j_mon.fleet_monitor_init(j_cfg, 3)
    outs = []
    for t0 in range(0, 512, 128):
        st_b, o = t_ops.fleet_monitor_scan(
            t_cfg, st_b, torch.as_tensor(tc[:, t0:t0 + 128],
                                         dtype=torch.float32),
            torch.as_tensor(blocked[:, t0:t0 + 128]), impl=impl)
        st_j, _ = j_ops.fleet_monitor_scan(
            j_cfg, st_j, jnp.asarray(tc[:, t0:t0 + 128], jnp.float32),
            jnp.asarray(blocked[:, t0:t0 + 128]), impl="scan", block_q=8)
        outs.append(o)
    np.testing.assert_array_equal(st_a.epoch.numpy(), st_b.epoch.numpy())
    np.testing.assert_array_equal(st_b.epoch.numpy(), np.asarray(st_j.epoch))
    ep_b = torch.cat([o.epoch for o in outs], dim=1).numpy()
    np.testing.assert_array_equal(out_a.epoch.numpy(), ep_b)
    np.testing.assert_allclose(st_a.mean.numpy(), st_b.mean.numpy(),
                               rtol=2e-4, atol=1e-3)
    np.testing.assert_allclose(st_b.last_qbar.numpy(),
                               np.asarray(st_j.last_qbar), rtol=1e-4)
    np.testing.assert_array_equal(st_b.win.numpy(), np.asarray(st_j.win))


def test_state_from_jax_half_run():
    """Run the first half in the JAX package, carry its state across
    through ``fleet_state_from_numpy``, finish in the port: the result
    equals one JAX run over the whole stream."""
    t_cfg, j_cfg = _cfgs({})
    tc, blocked = _noisy_streams(Q=4, T=640, seed=12)
    half = 320
    st_j, _ = j_mon.run_monitor_fleet(j_cfg, tc[:, :half],
                                      blocked[:, :half], chunk_t=160,
                                      impl="scan", mode="state", block_q=8)
    leaves = {k: np.asarray(v) for k, v in st_j._asdict().items()}
    st_t = t_mon.fleet_state_from_numpy(leaves, device="cpu")
    st_t, out_t = t_mon.run_monitor_fleet(t_cfg, tc[:, half:],
                                          blocked[:, half:], state=st_t,
                                          chunk_t=160, block_q=8,
                                          device="cpu")
    st_w, out_w = j_mon.run_monitor_fleet(j_cfg, tc, blocked, chunk_t=160,
                                          impl="scan", block_q=8)
    np.testing.assert_array_equal(st_t.epoch.numpy(), np.asarray(st_w.epoch))
    np.testing.assert_array_equal(out_t.epoch.numpy(),
                                  np.asarray(out_w.epoch)[:, half:])
    np.testing.assert_allclose(st_t.last_qbar.numpy(),
                               np.asarray(st_w.last_qbar), rtol=1e-4)
    back = t_mon.fleet_state_to_numpy(st_t)
    assert set(back) == set(leaves)
    assert back["n_total"].tolist() == [640] * 4


def test_state_mode_matches_full_mode_and_donation():
    cfg = t_mon.MonitorConfig()
    tc, blocked = _noisy_streams(Q=4, T=400, seed=5)
    st_full, _ = t_mon.run_monitor_fleet(cfg, tc, blocked, mode="full",
                                         device="cpu")
    lent = t_mon.fleet_monitor_init(cfg, 4, device="cpu")
    st_state, out = t_mon.run_monitor_fleet(cfg, tc, blocked, mode="state",
                                            state=lent, device="cpu")
    assert out is None
    assert int(lent.s_fill.sum()) == 0      # a lent state is not mutated
    for a, b in zip(st_full, st_state):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    given = t_mon.fleet_monitor_init(cfg, 4, device="cpu")
    st_don, _ = t_mon.run_monitor_fleet(cfg, tc, blocked, mode="state",
                                        state=given, donate=True,
                                        pad_q=False, device="cpu")
    assert st_don.win.data_ptr() == given.win.data_ptr()  # in place
    np.testing.assert_array_equal(st_don.epoch.numpy(),
                                  st_state.epoch.numpy())


def test_tail_chunk_and_queue_padding():
    """A ragged T (tail chunk padded as blocked) and a Q off the block
    multiple report only real steps and real queues."""
    cfg = t_mon.MonitorConfig()
    tc, blocked = _noisy_streams(Q=5, T=300, seed=1)
    st, out = t_mon.run_monitor_fleet(cfg, tc, blocked, chunk_t=128,
                                      block_q=4, device="cpu")
    assert out.q.shape == (5, 300) and st.epoch.shape == (5,)
    np.testing.assert_array_equal(st.n_total.numpy(), [300] * 5)
    np.testing.assert_array_equal(st.n_blocked.numpy(), blocked.sum(1))
    st2, _ = t_mon.run_monitor_fleet(cfg, tc, blocked, chunk_t=300,
                                     pad_q=False, device="cpu")
    np.testing.assert_array_equal(st.epoch.numpy(), st2.epoch.numpy())


def test_unported_and_unknown_impls_raise():
    """``rounds`` is ported (it runs and agrees with the scan); unknown
    impls and an unsupported LoG radius still raise."""
    cfg = t_mon.MonitorConfig()
    tc = np.ones((2, 40))
    st_r, _ = t_mon.run_monitor_fleet(cfg, tc, impl="rounds", device="cpu")
    st_s, _ = t_mon.run_monitor_fleet(cfg, tc, impl="scan", device="cpu")
    np.testing.assert_array_equal(st_r.epoch.numpy(), st_s.epoch.numpy())
    np.testing.assert_array_equal(st_r.win.numpy(), st_s.win.numpy())
    with pytest.raises(ValueError):
        t_mon.run_monitor_fleet(cfg, tc, impl="pallas", device="cpu")
    with pytest.raises(NotImplementedError):
        t_ref.fleet_static_params(t_mon.MonitorConfig(log_radius=2))


def test_ladder_matches_plain_window_sums():
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(3, 50)), dtype=torch.float64)
    for n in (1, 5, 16, 28):
        want = torch.stack([x[:, i:i + n].sum(1)
                            for i in range(50 - n + 1)], 1)
        np.testing.assert_allclose(t_ref.slide_sum_valid(x, n).numpy(),
                                   want.numpy(), rtol=1e-12)
        wmax = torch.stack([x[:, i:i + n].amax(1)
                            for i in range(50 - n + 1)], 1)
        np.testing.assert_array_equal(t_ref.slide_max_valid(x, n).numpy(),
                                      wmax.numpy())


# -- the time-major tile (the monitoring service's staging layout) -------------

def _time_major(a, dtype):
    """(Q, T) values as the ``.T`` view of a contiguous (T, Q) tensor."""
    return torch.as_tensor(np.ascontiguousarray(a.T), dtype=dtype).T


@pytest.mark.parametrize("impl", ["cuda", "scan"])
@pytest.mark.parametrize("mode", ["full", "state"])
@pytest.mark.parametrize("pad_q", [True, False])
def test_time_major_tile_matches_row_major(mode, impl, pad_q):
    """``tc``/``blocked`` given as ``.T`` views of (T, Q) tensors give the
    row-major call's outputs and state, leaf for leaf: Q = 5 off the
    block_q = 4 multiple, T = 300 in chunks of 128 (a 44-step tail)."""
    cfg = t_mon.MonitorConfig()
    tc, blocked = _noisy_streams(Q=5, T=300, seed=21)
    tm_tc = _time_major(tc, torch.float32)
    tm_blk = _time_major(blocked, torch.bool)
    assert tm_tc.stride(0) == 1 and not tm_tc.is_contiguous()
    kw = dict(chunk_t=128, block_q=4, mode=mode, impl=impl, pad_q=pad_q,
              device="cpu")
    st_r, out_r = t_mon.run_monitor_fleet(
        cfg, torch.as_tensor(tc, dtype=torch.float32),
        torch.as_tensor(blocked), **kw)
    st_t, out_t = t_mon.run_monitor_fleet(cfg, tm_tc, tm_blk, **kw)
    assert int(st_r.epoch.sum()) > 0
    for a, b in zip(st_t, st_r):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    if mode == "full":
        for a, b in zip(out_t, out_r):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    else:
        assert out_t is None and out_r is None


@pytest.mark.parametrize("with_blocked", [True, False])
def test_time_major_compaction_is_the_row_major_one_transposed(with_blocked):
    """``_compact`` on a time-major tile scatters along the time axis of
    a (T + 1, Q) buffer: the row-major compaction's planes, transposed,
    with the tile's unit row stride kept for the kernel."""
    tc, blocked = _noisy_streams(Q=7, T=40, seed=2, p_block=0.3)
    blk = blocked if with_blocked else None
    comp_r, m_r, cnt_r = t_ops._compact(
        torch.as_tensor(tc, dtype=torch.float32),
        None if blk is None else torch.as_tensor(blk))
    comp_t, m_t, cnt_t = t_ops._compact(
        _time_major(tc, torch.float32),
        None if blk is None else _time_major(blk, torch.bool))
    assert comp_t.shape == (7, 40) and comp_t.stride(0) == 1
    assert comp_t.stride(1) >= 7
    np.testing.assert_array_equal(comp_t.numpy(), comp_r.numpy())
    np.testing.assert_array_equal(m_t.numpy(), m_r.numpy())
    np.testing.assert_array_equal(cnt_t.numpy(), cnt_r.numpy())
    if with_blocked:                    # the zero tail past m
        assert (m_r.numpy() < 40).any()
        for q in range(7):
            assert (comp_t[q, int(m_t[q]):] == 0).all()


def test_service_dispatch_hands_over_a_time_major_tile(monkeypatch):
    """The service uploads its (chunk_t, S) staging as it is and hands
    the estimator the ``.T`` view, unit row stride, unpadded; the
    estimates are those of the row-major one-shot run."""
    from repro_torch.streams import (CounterArena, FleetMonitorService,
                                     InstrumentedQueue)
    from repro_torch.streams import fleet as t_fleet
    seen = []

    def spy(cfg, tc, blocked, **kw):
        seen.append((tc.shape, tc.stride(), blocked.stride(),
                     kw.get("pad_q")))
        return t_mon.run_monitor_fleet(cfg, tc, blocked, **kw)

    monkeypatch.setattr(t_fleet, "run_monitor_fleet", spy)
    Q, T = 3, 192
    tc, blocked = _noisy_streams(Q=Q, T=T, seed=5, p_block=0.05)
    arena = CounterArena(8)
    queues = [InstrumentedQueue(8, arena=arena) for _ in range(Q)]
    svc = FleetMonitorService(queues, t_mon.MonitorConfig(), period_s=1e-3,
                              chunk_t=32, scale_to_period=False,
                              device="cpu")
    for t in range(T):
        for qi, qu in enumerate(queues):
            qu.head.tc = float(tc[qi, t])
            qu.head.blocked = bool(blocked[qi, t])
        svc.sample()
    svc.flush()
    svc.stop()
    dispatches = [s for s in seen if s[0] == (Q, 32)]
    assert len(dispatches) >= T // 32
    for shape, ts, bs, pad_q in dispatches:
        assert ts == (1, Q) and bs == (1, Q) and pad_q is False
    st, _ = t_mon.run_monitor_fleet(t_mon.MonitorConfig(), tc, blocked,
                                    mode="state", chunk_t=32, device="cpu")
    np.testing.assert_array_equal(svc.epochs(), st.epoch.numpy())
    assert svc.epochs().min() >= 1


# -- the reference's signatures and keyword calls ------------------------------

@pytest.mark.parametrize("name", ["fleet_monitor_q", "fleet_monitor_step",
                                  "run_monitor_fleet", "fleet_monitor_scan"])
def test_monitor_signatures_match_the_reference(name):
    """Every parameter both packages have sits in the same order and
    kind; the reference's ``use_pallas``/``interpret``/``sub_t`` are all
    there."""
    mod_t, mod_j = ((t_mon, j_mon) if name == "run_monitor_fleet"
                    else (t_ops, j_ops))
    ref = inspect.signature(getattr(mod_j, name)
                            if name != "fleet_monitor_scan"
                            else j_ops._fleet_monitor_scan_impl).parameters
    got = inspect.signature(getattr(mod_t, name)).parameters
    shared = [p for p in ref if p in got]
    assert [p for p in got if p in ref] == shared
    assert set(ref) <= set(got)
    for p in shared:
        assert got[p].kind == ref[p].kind, p
    for p in ("use_pallas", "interpret"):
        if p in ref:
            assert p in got


def test_reference_keyword_calls_run_on_the_port():
    """The reference's keyword calls (``use_pallas=False``,
    ``interpret=True``) give the port's results and the JAX package's."""
    rng = np.random.default_rng(3)
    win = rng.uniform(50, 150, (6, 32)).astype(np.float32)
    q_plain = t_ops.fleet_monitor_q(torch.as_tensor(win), use_pallas=False,
                                    interpret=True, block_q=8)
    q_kern = t_ops.fleet_monitor_q(torch.as_tensor(win), use_pallas=True)
    np.testing.assert_array_equal(q_plain.numpy(), q_kern.numpy())
    np.testing.assert_allclose(
        q_plain.numpy(), np.asarray(j_ops.fleet_monitor_q(
            jnp.asarray(win), use_pallas=False)), rtol=1e-4)
    t_cfg, _ = _cfgs({})
    st = t_ops.fleet_step_init(t_cfg, 6, device="cpu")
    q1, _, s1 = t_ops.fleet_monitor_step(torch.as_tensor(win), st,
                                         cfg=t_cfg, use_pallas=False,
                                         interpret=True)
    q2, _, s2 = t_ops.fleet_monitor_step(torch.as_tensor(win), st,
                                         cfg=t_cfg)
    np.testing.assert_array_equal(q1.numpy(), q2.numpy())
    np.testing.assert_array_equal(s1.numpy(), s2.numpy())

    tc, blocked = _noisy_streams(Q=3, T=128, seed=8)
    st_a, out_a = t_mon.run_monitor_fleet(t_cfg, tc, blocked, chunk_t=64,
                                          interpret=True, block_q=8,
                                          device="cpu")
    st_b, out_b = t_mon.run_monitor_fleet(t_cfg, tc, blocked, chunk_t=64,
                                          block_q=8, device="cpu")
    for a, b in zip(tuple(st_a) + tuple(out_a), tuple(st_b) + tuple(out_b)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    s0 = t_mon.fleet_monitor_init(t_cfg, 3, device="cpu")
    st_c, _ = t_ops.fleet_monitor_scan(
        t_cfg, s0, torch.as_tensor(tc, dtype=torch.float32),
        torch.as_tensor(blocked), impl="scan", mode="state",
        interpret=True, block_q=8)
    np.testing.assert_array_equal(st_c.epoch.numpy(), st_a.epoch.numpy())
