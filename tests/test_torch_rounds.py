"""The port's segmented fleet scan (``kernels/monitor/rounds.py``) against
the JAX package's, which runs under jax on the CPU in the same process.

The streams are the JAX package's fleet tests' (``tests/test_monitor_
fleet.py``): noisy Poisson counts with blocked samples, every config
those tests use, full and state mode, and sub-tiles of 8, 16 and 32
steps.  Epochs and convergence flags must be equal and the estimates
within those tests' tolerances (rtol 1e-4, atol 1e-3; the final mean to
rtol 2e-4).  The port's rounds is also held to its own sequential scan
and to the float64 ``HostMonitor``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.monitor import MonitorConfig as JCfg
from repro.core.monitor import fleet_monitor_init as j_init
from repro.kernels.monitor.ops import fleet_monitor_scan as j_scan
from repro_torch.core.monitor import HostMonitor
from repro_torch.core.monitor import MonitorConfig as TCfg
from repro_torch.core.monitor import fleet_monitor_init as t_init
from repro_torch.core.monitor import run_monitor_fleet
from repro_torch.kernels.monitor.ops import fleet_monitor_scan as t_scan

torch.set_num_threads(1)

SUB_T = [8, 16, 32]
CFGS = {"window_std": {}, "stderr": {"sigma_mode": "stderr"},
        "paper": "paper"}


def _cfgs(name):
    kw = CFGS[name]
    if kw == "paper":
        return TCfg.paper_faithful(), JCfg.paper_faithful()
    return TCfg(**kw), JCfg(**kw)


def _noisy_streams(Q=5, T=700, seed=0, p_block=0.06):
    rng = np.random.default_rng(seed)
    base = rng.uniform(100, 400, (Q, 1))
    tc = rng.poisson(base, (Q, T)).astype(np.float64)
    blocked = rng.random((Q, T)) < p_block
    return tc, blocked


def _drive_port(cfg, tc, blocked, chunk, sub_t, mode):
    st = t_init(cfg, tc.shape[0], device="cpu")
    outs = []
    for t0 in range(0, tc.shape[1], chunk):
        st, o = t_scan(cfg, st, torch.as_tensor(tc[:, t0:t0 + chunk],
                                                dtype=torch.float32),
                       torch.as_tensor(blocked[:, t0:t0 + chunk]),
                       impl="rounds", mode=mode, sub_t=sub_t)
        outs.append(o)
    return st, outs


def _drive_ref(cfg, tc, blocked, chunk, sub_t, mode):
    st = j_init(cfg, tc.shape[0])
    outs = []
    for t0 in range(0, tc.shape[1], chunk):
        st, o = j_scan(cfg, st, jnp.asarray(tc[:, t0:t0 + chunk],
                                            jnp.float32),
                       jnp.asarray(blocked[:, t0:t0 + chunk]),
                       impl="rounds", mode=mode, sub_t=sub_t)
        outs.append(o)
    return st, outs


def _cat(outs, name, lib=np.asarray):
    return np.concatenate([lib(getattr(o, name)) for o in outs], axis=1)


def _assert_state_close(st_t, st_j):
    np.testing.assert_array_equal(st_t.epoch.numpy(), np.asarray(st_j.epoch))
    np.testing.assert_array_equal(st_t.s_fill.numpy(),
                                  np.asarray(st_j.s_fill))
    np.testing.assert_array_equal(st_t.count.numpy(), np.asarray(st_j.count))
    np.testing.assert_array_equal(st_t.win.numpy(), np.asarray(st_j.win))
    np.testing.assert_array_equal(st_t.n_blocked.numpy(),
                                  np.asarray(st_j.n_blocked))
    for name in ("mean", "last_qbar"):
        np.testing.assert_allclose(getattr(st_t, name).numpy(),
                                   np.asarray(getattr(st_j, name)),
                                   rtol=2e-4, atol=1e-3, err_msg=name)


@pytest.mark.parametrize("sub_t", SUB_T)
@pytest.mark.parametrize("cfg_name", sorted(CFGS))
def test_rounds_full_mode_matches_the_reference(cfg_name, sub_t):
    """Full mode, (Q, T) outputs step for step: epochs and convergence
    flags exact, q / q-bar / estimates to rtol 1e-4, atol 1e-3."""
    t_cfg, j_cfg = _cfgs(cfg_name)
    tc, blocked = _noisy_streams(Q=4, T=600, seed=3)
    st_t, o_t = _drive_port(t_cfg, tc, blocked, 200, sub_t, "full")
    st_j, o_j = _drive_ref(j_cfg, tc, blocked, 200, sub_t, "full")
    if cfg_name != "paper":              # paper-faithful: no reset in 600
        assert int(st_t.epoch.min()) >= 1      # resets are exercised
    for name in ("epoch", "converged"):
        np.testing.assert_array_equal(_cat(o_t, name), _cat(o_j, name),
                                      err_msg=name)
    for name in ("q", "qbar", "estimate"):
        np.testing.assert_allclose(_cat(o_t, name), _cat(o_j, name),
                                   rtol=1e-4, atol=1e-3, err_msg=name)
    _assert_state_close(st_t, st_j)


@pytest.mark.parametrize("sub_t", SUB_T)
def test_rounds_state_mode_matches_the_reference(sub_t):
    t_cfg, j_cfg = _cfgs("window_std")
    tc, blocked = _noisy_streams(Q=5, T=512, seed=9)
    st_t, o_t = _drive_port(t_cfg, tc, blocked, 128, sub_t, "state")
    st_j, _ = _drive_ref(j_cfg, tc, blocked, 128, sub_t, "state")
    assert all(o is None for o in o_t)
    _assert_state_close(st_t, st_j)


@pytest.mark.parametrize("sub_t", SUB_T)
def test_rounds_matches_host_monitor_per_epoch(sub_t):
    """Every epoch's estimate against the float64 HostMonitor (rtol
    1e-4), epoch counts identical."""
    cfg = TCfg()
    tc, blocked = _noisy_streams()
    epochs, ests = [], []
    for q in range(tc.shape[0]):
        hm = HostMonitor(cfg)
        per = []
        for t, b in zip(tc[q], blocked[q]):
            if hm.update(float(t), bool(b)):
                per.append(hm.estimates[-1])
        epochs.append(hm.epoch)
        ests.append(per)
    assert sum(epochs) >= 5
    st, out = run_monitor_fleet(cfg, tc, blocked, chunk_t=256, impl="rounds",
                                block_q=8, sub_t=sub_t, device="cpu")
    np.testing.assert_array_equal(st.epoch.numpy(), epochs)
    conv, est = out.converged.numpy(), out.estimate.numpy()
    for q in range(tc.shape[0]):
        np.testing.assert_allclose(est[q][conv[q]], ests[q], rtol=1e-4)


@pytest.mark.parametrize("cfg_name", sorted(CFGS))
def test_rounds_matches_the_port_scan(cfg_name):
    """The port's rounds against its own sequential scan: epochs and
    flags exact, outputs and carried state within the fleet tests'
    tolerances, full and state mode agreeing."""
    t_cfg, _ = _cfgs(cfg_name)
    tc, blocked = _noisy_streams(Q=4, T=600, seed=3)
    st_r, o_r = run_monitor_fleet(t_cfg, tc, blocked, chunk_t=200,
                                  impl="rounds", block_q=8, device="cpu")
    st_s, o_s = run_monitor_fleet(t_cfg, tc, blocked, chunk_t=200,
                                  impl="scan", block_q=8, device="cpu")
    np.testing.assert_array_equal(o_r.epoch.numpy(), o_s.epoch.numpy())
    np.testing.assert_array_equal(o_r.converged.numpy(),
                                  o_s.converged.numpy())
    for name in ("q", "qbar", "estimate"):
        np.testing.assert_allclose(getattr(o_r, name).numpy(),
                                   getattr(o_s, name).numpy(),
                                   rtol=1e-4, atol=1e-3, err_msg=name)
    np.testing.assert_array_equal(st_r.win.numpy(), st_s.win.numpy())
    st_m, out = run_monitor_fleet(t_cfg, tc, blocked, chunk_t=200,
                                  impl="rounds", mode="state", block_q=8,
                                  device="cpu")
    assert out is None
    for a, b in zip(st_r, st_m):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_rounds_discards_blocked_samples():
    cfg = TCfg()
    Q, T = 3, 64
    tc = np.full((Q, T), 100.0)
    blocked = np.zeros((Q, T), bool)
    blocked[1] = True                    # queue 1 fully blocked
    st, out = run_monitor_fleet(cfg, tc, blocked, chunk_t=32,
                                impl="rounds", block_q=8, device="cpu")
    assert int(st.s_fill[1]) == 0
    assert int(st.n_blocked[1]) == T
    assert int(st.s_fill[0]) == cfg.window
    assert not bool(out.converged[1].any())


def test_rounds_state_carries_across_dispatches():
    """Chunked dispatches agree exactly with one big dispatch."""
    cfg = TCfg()
    tc, blocked = _noisy_streams(Q=3, T=512, seed=9)
    st_a, out_a = run_monitor_fleet(cfg, tc, blocked, chunk_t=512,
                                    impl="rounds", block_q=8, device="cpu")
    st_b, outs = _drive_port(cfg, tc, blocked, 128, 32, "full")
    np.testing.assert_array_equal(st_a.epoch.numpy(), st_b.epoch.numpy())
    np.testing.assert_array_equal(out_a.epoch.numpy(),
                                  _cat(outs, "epoch", lambda a: a.numpy()))
    np.testing.assert_allclose(st_a.mean.numpy(), st_b.mean.numpy(),
                               rtol=2e-4, atol=1e-3)
