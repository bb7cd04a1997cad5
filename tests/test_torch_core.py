"""Parity of the port's core modules with the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages;
JAX stays on the CPU.  Tolerances: float32 paths 1e-5 relative unless
stated (different summation orders in XLA and PyTorch), float64 host
paths exact or 1e-12.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import controller as j_ctl
from repro.core import filters as j_filters
from repro.core import monitor as j_mon
from repro.core import queueing as j_q
from repro.core import simulate as j_sim
from repro.core import stats as j_stats
from repro_torch.core import controller as t_ctl
from repro_torch.core import filters as t_filters
from repro_torch.core import monitor as t_mon
from repro_torch.core import queueing as t_q
from repro_torch.core import simulate as t_sim
from repro_torch.core import stats as t_stats

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


def _noisy_streams(Q=4, T=600, seed=3, p_block=0.06):
    rng = np.random.default_rng(seed)
    base = rng.uniform(100, 400, (Q, 1))
    tc = rng.poisson(base, (Q, T)).astype(np.float64)
    blocked = rng.random((Q, T)) < p_block
    return tc, blocked


# -- filters -----------------------------------------------------------------

@pytest.mark.parametrize("radius,sigma,normalize",
                         [(2, 1.0, True), (2, 1.0, False), (3, 1.5, True),
                          (1, 0.5, True)])
def test_filter_kernels_match(radius, sigma, normalize):
    np.testing.assert_array_equal(
        t_filters.gaussian_kernel(radius, sigma, normalize=normalize),
        j_filters.gaussian_kernel(radius, sigma, normalize=normalize))
    np.testing.assert_array_equal(t_filters.log_kernel(radius, sigma),
                                  j_filters.log_kernel(radius, sigma))


@pytest.mark.parametrize("shape", [(40,), (3, 33), (2, 5, 17)])
def test_convolve_valid_matches(shape):
    rng = np.random.default_rng(len(shape))
    x = rng.uniform(0, 300, shape)
    k = t_filters.gaussian_kernel(2, 1.0)
    # float64 numpy on the host: identical arithmetic
    np.testing.assert_array_equal(t_filters.convolve_valid(x, k),
                                  j_filters.convolve_valid(x, k))
    # float32 tensors against float32 jnp
    got = t_filters.gaussian_filter_valid(torch.as_tensor(x, dtype=torch.float32))
    want = j_filters.gaussian_filter_valid(jnp.asarray(x, jnp.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    got = t_filters.log_filter_valid(torch.as_tensor(x, dtype=torch.float32))
    want = j_filters.log_filter_valid(jnp.asarray(x, jnp.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-3)
    with pytest.raises(ValueError):
        t_filters.convolve_valid(np.zeros(3), k)


# -- stats -------------------------------------------------------------------

def test_welford_matches():
    rng = np.random.default_rng(1)
    xs = rng.normal(50.0, 7.0, 200).astype(np.float32)
    ts = t_stats.welford_init(device="cpu")
    js = j_stats.welford_init()
    for x in xs:
        ts = t_stats.welford_update(ts, torch.tensor(x))
        js = j_stats.welford_update(js, jnp.float32(x))
    for a, b in zip(ts, js):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
    for fn in ("welford_variance", "welford_std", "welford_stderr"):
        np.testing.assert_allclose(float(getattr(t_stats, fn)(ts)),
                                   float(getattr(j_stats, fn)(js)),
                                   rtol=1e-6)
    half = len(xs) // 2
    ta = t_stats.welford_init(device="cpu")
    tb = t_stats.welford_init(device="cpu")
    for x in xs[:half]:
        ta = t_stats.welford_update(ta, torch.tensor(x))
    for x in xs[half:]:
        tb = t_stats.welford_update(tb, torch.tensor(x))
    merged = t_stats.welford_merge(ta, tb)
    np.testing.assert_allclose(float(merged.mean), float(ts.mean), rtol=1e-5)
    np.testing.assert_allclose(float(merged.m2), float(ts.m2), rtol=1e-4)
    empty = t_stats.welford_merge(t_stats.welford_init(device="cpu"),
                                  t_stats.welford_init(device="cpu"))
    assert float(empty.mean) == 0.0 and float(t_stats.welford_stderr(empty)) == 0


@pytest.mark.parametrize("masked", [False, True])
def test_moments_batch_matches(masked):
    rng = np.random.default_rng(7)
    x = rng.exponential(2.0, (5, 40))
    where = rng.random((5, 40)) > 0.3 if masked else None
    t0 = t_stats.Moments(*(np.zeros(5) for _ in range(5)))
    j0 = j_stats.Moments(*(np.zeros(5) for _ in range(5)))
    # numpy float64 on the host: the port stays in float64
    t1 = t_stats.moments_update_batch(t0, x, where=where)
    t2 = t_stats.moments_update_batch(t1, x[:, ::-1], where=where)
    j1 = j_stats.moments_update_batch(j0, x, where=where)
    j2 = j_stats.moments_update_batch(j1, x[:, ::-1], where=where)
    for a, b in zip(t_stats.moments_finalize(t2),
                    j_stats.moments_finalize(j2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-5,
                                   atol=1e-6)
    # the tensor path agrees with the numpy path
    tt = t_stats.moments_update_batch(
        t_stats.moments_init(torch.float64, (5,), device="cpu"),
        torch.as_tensor(x),
        where=None if where is None else torch.as_tensor(where))
    for a, b in zip(tt, t1):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-12)


def test_moments_scalar_updates_match():
    rng = np.random.default_rng(2)
    ts, js = t_stats.moments_init(device="cpu"), j_stats.moments_init()
    for x in rng.exponential(1.5, 64):
        ts = t_stats.moments_update(ts, float(x))
        js = j_stats.moments_update(js, float(x))
    for a, b in zip(t_stats.moments_finalize(ts),
                    j_stats.moments_finalize(js)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-4, atol=1e-5)


# -- Algorithm 1, per-queue and host forms -----------------------------------

def test_config_round_trips():
    for spec in CONFIGS:
        t_cfg, j_cfg = _cfgs(spec)
        assert t_mon.MonitorConfig(**dataclasses.asdict(j_cfg)) == t_cfg
        assert j_mon.MonitorConfig(**dataclasses.asdict(t_cfg)) == j_cfg
        assert t_cfg.sig_trace_len == j_cfg.sig_trace_len
    with pytest.raises(ValueError):
        t_mon.MonitorConfig(window=4)
    with pytest.raises(ValueError):
        t_mon.MonitorConfig(sigma_mode="nope")


@pytest.mark.parametrize("spec", CONFIGS, ids=CFG_IDS)
def test_run_monitor_matches_jax(spec):
    """The batched per-queue state machine reproduces vmap(run_monitor):
    epochs and convergence exact, q/q-bar/estimate to 1e-4."""
    t_cfg, j_cfg = _cfgs(spec)
    tc, blocked = _noisy_streams()
    ref = jax.vmap(lambda t, b: j_mon.run_monitor(j_cfg, t, b))(
        jnp.asarray(tc, jnp.float32), jnp.asarray(blocked))
    out = t_mon.run_monitor(t_cfg, tc, blocked, device="cpu")
    np.testing.assert_array_equal(out.epoch.numpy(), np.asarray(ref.epoch))
    np.testing.assert_array_equal(out.converged.numpy(),
                                  np.asarray(ref.converged))
    for name in ("q", "qbar", "sigma_qbar", "estimate"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-4, atol=1e-3)


def test_run_monitor_single_stream_shape():
    t_cfg, j_cfg = _cfgs({})
    tc, blocked = _noisy_streams(Q=1, T=300, seed=8)
    out = t_mon.run_monitor(t_cfg, tc[0], blocked[0], device="cpu")
    ref = j_mon.run_monitor(j_cfg, tc[0], blocked[0])
    assert out.q.shape == (300,)
    np.testing.assert_array_equal(out.epoch.numpy(), np.asarray(ref.epoch))


@pytest.mark.parametrize("spec", CONFIGS, ids=CFG_IDS)
def test_host_monitor_matches_jax(spec):
    """The float64 host monitors run identical arithmetic."""
    t_cfg, j_cfg = _cfgs(spec)
    tc, blocked = _noisy_streams(Q=2, T=700, seed=0)
    for q in range(2):
        th, jh = t_mon.HostMonitor(t_cfg), j_mon.HostMonitor(j_cfg)
        for t, b in zip(tc[q], blocked[q]):
            assert th.update(float(t), bool(b)) == jh.update(float(t),
                                                             bool(b))
        assert th.epoch == jh.epoch
        assert th.estimates == jh.estimates
        assert th.rate_items_per_s() == jh.rate_items_per_s()
        assert th.observed_blocking_fraction() == \
            jh.observed_blocking_fraction()


@pytest.mark.parametrize("spec", [dict(window=16, min_q_samples=16), {},
                                  dict(window=32, sigma_mode="stderr")],
                         ids=["w16", "default", "stderr"])
def test_host_monitor_long_stream_matches_jax(spec):
    """Over many epochs, resets and a phase change, the port's
    incremental filters and bare-ufunc reductions give the JAX package's
    numpy HostMonitor bit for bit."""
    t_cfg, j_cfg = _cfgs(spec)
    rng = np.random.default_rng(11)
    tc = rng.poisson(rng.uniform(5, 300), 12000).astype(float)
    tc[5000:] *= 0.4
    blocked = rng.random(12000) < 0.05
    th, jh = t_mon.HostMonitor(t_cfg), j_mon.HostMonitor(j_cfg)
    got = [th.update(t, b) for t, b in zip(tc.tolist(), blocked.tolist())]
    want = [jh.update(t, b) for t, b in zip(tc.tolist(), blocked.tolist())]
    assert got == want and sum(got) > 10
    assert th.estimates == jh.estimates
    assert th.qbar == jh.qbar


def test_sampling_period_controller_matches():
    rng = np.random.default_rng(5)
    tp, jp = t_mon.SamplingPeriodController(), \
        j_mon.SamplingPeriodController()
    for _ in range(300):
        jitter = float(rng.uniform(0.5, 1.6))
        blocked = bool(rng.random() < 0.1)
        assert tp.observe(tp.period_s * jitter, blocked) == \
            jp.observe(jp.period_s * jitter, blocked)
    assert tp.failed == jp.failed


def test_entry_points_refuse_missing_card():
    """Without a card the default device raises instead of running on
    the host (the tests ask for the CPU explicitly)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cfg = t_mon.MonitorConfig()
    with pytest.raises(RuntimeError, match="CUDA"):
        t_mon.run_monitor_fleet(cfg, np.zeros((2, 40)))
    with pytest.raises(RuntimeError, match="CUDA"):
        t_mon.fleet_monitor_init(cfg, 4)


def test_monitor_init_defaults_to_the_card():
    """``monitor_init`` defaults to the card like every other entry
    point: without one it raises, and ``device="cpu"`` runs on the host
    with the JAX package's state layout."""
    cfg = t_mon.MonitorConfig()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_mon.monitor_init(cfg)
    st = t_mon.monitor_init(cfg, device="cpu")
    assert st.s_buf.device.type == "cpu"
    js = j_mon.monitor_init(j_mon.MonitorConfig())
    for a, b in zip(st, js):
        if isinstance(a, tuple):
            for x, y in zip(a, b):
                assert tuple(x.shape) == tuple(y.shape)
        else:
            assert tuple(a.shape) == tuple(b.shape)


@pytest.mark.parametrize("name", ["welford_init", "moments_init"])
def test_stats_init_defaults_to_the_card(name):
    """The statistics' public constructors default to the card like
    ``monitor_init``: without one they raise, and ``device="cpu"`` gives
    the JAX package's empty state, leaf for leaf."""
    make = getattr(t_stats, name)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    st = make(torch.float32, device="cpu")
    js = getattr(j_stats, name)(jnp.float32)
    assert type(st)._fields == type(js)._fields
    for a, b in zip(st, js):
        assert a.device.type == "cpu" and a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_fleet_state_numpy_round_trip():
    cfg = t_mon.MonitorConfig()
    js = j_mon.fleet_monitor_init(j_mon.MonitorConfig(), 5)
    leaves = {k: np.asarray(v) for k, v in js._asdict().items()}
    st = t_mon.fleet_state_from_numpy(leaves, device="cpu")
    assert st.s_fill.dtype == torch.int32 and st.win.shape == (5, cfg.window)
    back = t_mon.fleet_state_to_numpy(st)
    for k in leaves:
        np.testing.assert_array_equal(back[k], leaves[k])
    with pytest.raises(ValueError):
        t_mon.fleet_state_from_numpy({"win": leaves["win"]}, device="cpu")


def test_gated_rate_readout_matches():
    cfg_t, cfg_j = _cfgs({})
    rng = np.random.default_rng(3)
    epoch = rng.integers(0, 3, 50)
    count = rng.integers(0, 64, 50).astype(float)
    mean, last = rng.uniform(0, 400, 50), rng.uniform(0, 400, 50)
    np.testing.assert_array_equal(
        t_mon.gated_rate_arrays(cfg_t, torch.as_tensor(epoch), count, mean,
                                last, 1e-3),
        j_mon.gated_rate_arrays(cfg_j, epoch, count, mean, last, 1e-3))


# -- queueing model and controllers ------------------------------------------

@pytest.mark.parametrize("lam,mu,K", [(1.0, 2.0, 8.0), (3.0, 2.0, 5.0),
                                      (2.0, 2.0, 10.0), (0.5, 4.0, 1.0)])
def test_queueing_formulas_match(lam, mu, K):
    for name in ("mm1k_blocking_prob", "mm1k_throughput",
                 "mm1k_mean_occupancy", "md1k_throughput_approx"):
        np.testing.assert_allclose(float(getattr(t_q, name)(lam, mu, K)),
                                   float(getattr(j_q, name)(lam, mu, K)),
                                   rtol=1e-5)
    for T in (1e-3, 5e-3):
        np.testing.assert_allclose(
            float(t_q.pr_nonblocking_read(T, lam / mu, mu * 1e3)),
            float(j_q.pr_nonblocking_read(T, lam / mu, mu * 1e3)), rtol=1e-5)
        np.testing.assert_allclose(
            float(t_q.pr_nonblocking_write(T, 16, lam / mu, mu * 1e3)),
            float(j_q.pr_nonblocking_write(T, 16, lam / mu, mu * 1e3)),
            rtol=1e-5)
        assert t_q.expected_nonblocking_fraction(T, 16, 0.5, 2e3) == \
            pytest.approx(j_q.expected_nonblocking_fraction(T, 16, 0.5, 2e3),
                          rel=1e-5)


def test_buffer_size_search_matches():
    rng = np.random.default_rng(4)
    lam = rng.uniform(0.1, 10.0, 40)
    mu = rng.uniform(0.1, 10.0, 40)
    lam[:3] = 0.0
    cv2 = np.where(rng.random(40) < 0.5, 0.1, 1.0)
    got = t_q.optimal_buffer_size_fleet(lam, mu, cv2=cv2, max_k=1 << 12)
    want = j_q.optimal_buffer_size_fleet(lam, mu, cv2=cv2, max_k=1 << 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for i in range(3, 12):
        assert t_q.optimal_buffer_size(lam[i], mu[i], cv2=float(cv2[i])) == \
            j_q.optimal_buffer_size(lam[i], mu[i], cv2=float(cv2[i]))


def test_controllers_match():
    rng = np.random.default_rng(9)
    lam = rng.uniform(1.0, 9.0, 12)
    mu = rng.uniform(1.0, 9.0, 12)
    cur = rng.integers(2, 256, 12)
    tb, jb = t_ctl.BufferAutotuner(), j_ctl.BufferAutotuner()
    for a, b in zip(tb.maybe_resize_fleet(lam, mu, cur),
                    jb.maybe_resize_fleet(lam, mu, cur)):
        np.testing.assert_array_equal(a, b)
    assert tb.maybe_resize(3.0, 4.0) == jb.maybe_resize(3.0, 4.0)
    tp, jp = t_ctl.ParallelismController(), j_ctl.ParallelismController()
    np.testing.assert_array_equal(tp.replicas_fleet(lam, mu),
                                  jp.replicas_fleet(lam, mu))
    assert tp.should_scale(2, 9.0, 2.0) == jp.should_scale(2, 9.0, 2.0)
    ts, js = t_ctl.StragglerDetector(), j_ctl.StragglerDetector()
    rates = np.r_[rng.uniform(9, 11, 10), 3.0]
    np.testing.assert_array_equal(ts.straggler_mask(rates),
                                  js.straggler_mask(rates))
    hosts = [f"h{i}" for i in range(len(rates))]
    ts.report_fleet(hosts, rates)
    js.report_fleet(hosts, rates)
    assert ts.stragglers() == js.stragglers() == ["h10"]


def test_distribution_classifier_matches():
    rng = np.random.default_rng(6)
    q = 6
    x = np.stack([rng.exponential(1.0, 80) if i % 2 else
                  np.full(80, 2.0) + rng.normal(0, 0.01, 80)
                  for i in range(q)])
    where = rng.random((q, 80)) > 0.1
    tc, jc = (t_ctl.DistributionClassifier(n_streams=q),
              j_ctl.DistributionClassifier(n_streams=q))
    for c in (tc, jc):
        c.update_batch(x[:, :40], where=where[:, :40])
        c.update_batch(x[:, 40:], where=where[:, 40:])
    np.testing.assert_array_equal(tc.classify(), jc.classify())
    np.testing.assert_allclose(tc.cv2, np.asarray(jc.cv2), rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_array_equal(tc.counts, np.asarray(jc.counts))
    ts, js = t_ctl.DistributionClassifier(), j_ctl.DistributionClassifier()
    for v in x[1, :40]:
        ts.update(float(v))
        js.update(float(v))
    assert ts.classify() == js.classify()


def test_tandem_simulator_is_a_copy():
    cfg_t = t_sim.TandemConfig(n_items=5000, seed=3)
    cfg_j = j_sim.TandemConfig(n_items=5000, seed=3)
    rt, rj = t_sim.simulate_tandem(cfg_t), j_sim.simulate_tandem(cfg_j)
    tt, bt = t_sim.sample_periods_fleet([rt, rt], 1e-3)
    tj, bj = j_sim.sample_periods_fleet([rj, rj], 1e-3)
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_array_equal(bt, bj)
