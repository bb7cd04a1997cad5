"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.

Every test here needs an NVIDIA GPU and ``nvcc``; without a CUDA device
each one skips (decided inside the ``cuda`` fixture, never at import).
On a machine with the card run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

This file imports no JAX: the card's machine has none.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.monitor import (MonitorConfig, fleet_monitor_init,
                                      run_monitor_fleet)
from repro_torch.kernels.monitor import kernel as K
from repro_torch.kernels.monitor.ref import batched_monitor_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    K.build()
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


def test_cuda_tensor_never_falls_back(cuda):
    """A shape the kernel has no instance for raises on the card."""
    cfg = MonitorConfig(window=24)
    with pytest.raises(NotImplementedError):
        run_monitor_fleet(cfg, np.ones((4, 64), np.float32), device=cuda)
