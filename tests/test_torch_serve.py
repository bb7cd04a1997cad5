"""The port's serving engine against the JAX package's, on the CPU.

Both engines serve the smoke internlm2 model in float32 with one set of
weights (the JAX package initialises them; ``params_from_numpy`` carries
them across), so greedy tokens must agree exactly.  Rounds whose
composition matters are driven through ``Engine._serve_batch`` on both
engines with the same requests, which makes them deterministic; the
threaded path is checked with rounds whose tokens do not depend on their
composition (equal prompt lengths).

Two behaviours of the reference are reproduced on purpose (ROADMAP.md,
Queue 3): a round right-pads its prompts to its longest and takes each
row's first token from the last padded position, and a row decoded past
the end of the cache has its writes clamped to the last position.
"""

import inspect
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke
from repro.models import build_model as j_build_model
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model, params_from_numpy
from repro_torch.serve import Engine, Request, ServeConfig

torch.set_num_threads(1)

ARCH = "internlm2-1.8b"
B, S_MAX = 4, 32


@pytest.fixture(scope="module")
def pair():
    """(port engine, started; JAX engine, not started; port model, port
    params, cfg)."""
    cfg = get_smoke_config(ARCH)
    jm = j_build_model(j_get_smoke(ARCH), compute_dtype=jnp.float32)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = build_model(cfg, torch.float32)
    tp = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu", compute_dtype=torch.float32)
    eng = Engine(tm, tp, ServeConfig(batch_size=B, max_seq=S_MAX,
                                     queue_capacity=16), device="cpu")
    jeng = JEngine(jm, jp, JServeConfig(batch_size=B, max_seq=S_MAX,
                                        queue_capacity=16))
    eng.start()
    yield eng, jeng, tm, tp, cfg
    eng.stop()
    jeng.stop()


def _wait_until(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


def _prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
            for n in lens]


def _round(engine, req_cls, prompts, max_new):
    reqs = [req_cls(rid=i, tokens=p, max_new=m)
            for i, (p, m) in enumerate(zip(prompts, max_new))]
    engine._serve_batch(list(reqs))
    assert all(r.done.is_set() for r in reqs)
    return [r.out for r in reqs]


def _direct(tm, tp, rows, max_new, S=S_MAX):
    """Greedy prefill + decode of the given (B, L) rows with the model."""
    rows = np.asarray(rows, np.int32)
    L = rows.shape[1]
    logits, c = tm.prefill(tp, {"tokens": torch.as_tensor(rows)})
    cache = tm.init_cache(len(rows), S, device="cpu")
    for n in cache:
        cache[n][:, :, :L] = c[n]
    cur = torch.argmax(logits[:, -1], -1).to(torch.int32)
    pos = torch.full((len(rows),), L)
    outs = [cur.numpy().copy()]
    for _ in range(max_new - 1):
        cur, cache = tm.decode_step(tp, cache, cur, pos)
        pos = pos + 1
        outs.append(cur.numpy().copy())
    return np.stack(outs, 1)


def test_engine_serves_batched_requests(pair):
    """Threaded serving across both QoS lanes: every request answered
    with max_new tokens, no crash, the lanes' monitor dispatching."""
    eng, _, _, _, cfg = pair
    reqs = [Request(rid=i, tokens=p, max_new=4,
                    qos=("blocking", "nonblocking")[i % 2])
            for i, p in enumerate(_prompts(cfg, [8] * 6, seed=0))]
    for r in reqs:
        assert eng.submit(r)
    for r in reqs:
        assert r.done.wait(timeout=120), "request timed out"
        assert r.out is not None and r.out.shape == (4,)
    # a round sets each request's event before it counts it and records
    # its latency, so both trail the last wake-up briefly
    assert _wait_until(lambda: eng.served >= 6
                       and eng.latency_stats()["blocking"]["n"] >= 3)
    assert eng.stats()["crash_count"] == 0
    rates = eng.class_rates()
    assert set(rates) == {"blocking", "nonblocking"}
    assert all(np.isfinite(v) for d in rates.values() for v in d.values())
    assert eng.recommended_queue_capacity() >= 1


def test_engine_tokens_equal_direct_decode(pair):
    """A request served alone is its round replicated to the batch; its
    tokens equal a direct prefill + greedy decode of that batch."""
    eng, _, tm, tp, cfg = pair
    toks = np.arange(1, 9, dtype=np.int32) % cfg.vocab_size
    (out,) = _round(eng, Request, [toks], [5])
    np.testing.assert_array_equal(out, _direct(tm, tp, [toks] * B, 5)[0])


def test_equal_length_prompts_match_jax(pair):
    """Equal-length prompts: each row's tokens do not depend on the
    round, so the threaded port engine matches the JAX engine's rounds."""
    eng, jeng, _, _, cfg = pair
    prompts = _prompts(cfg, [10] * 5, seed=3)
    reqs = [Request(rid=100 + i, tokens=p, max_new=6)
            for i, p in enumerate(prompts)]
    for r in reqs:
        assert eng.submit(r)
    for r in reqs:
        assert r.done.wait(timeout=120)
    want = (_round(jeng, JRequest, prompts[:B], [6] * B)
            + _round(jeng, JRequest, prompts[B:], [6]))
    for r, w in zip(reqs, want):
        np.testing.assert_array_equal(r.out, w)


def test_mixed_lengths_take_the_first_token_from_padding(pair):
    """A round pads its prompts to its longest; a shorter prompt's first
    token is read at the last padded position — the reference's
    behaviour, reproduced token for token."""
    eng, jeng, tm, tp, cfg = pair
    prompts = _prompts(cfg, [5, 11, 8], seed=5)
    got = _round(eng, Request, prompts, [4, 4, 4])
    want = _round(jeng, JRequest, prompts, [4, 4, 4])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    padded = np.zeros((B, 11), np.int32)
    for i, p in enumerate(prompts + [prompts[-1]]):
        padded[i, :len(p)] = p
    logits, _ = tm.prefill(tp, {"tokens": torch.as_tensor(padded)})
    first = torch.argmax(logits[:, -1], -1).numpy()
    assert [int(g[0]) for g in got] == [int(t) for t in first[:3]]


def test_decode_past_the_cache_end_matches_jax(pair):
    """A row whose prompt was cut to S_max - max_new keeps decoding for
    the round's largest max_new, so its position passes S_max; the
    clamped cache writes must not fail and tokens match the JAX
    engine's."""
    eng, jeng, _, _, cfg = pair
    prompts = _prompts(cfg, [40, 6, 31], seed=7)
    max_new = [2, 9, 1]
    got = _round(eng, Request, prompts, max_new)
    want = _round(jeng, JRequest, prompts, max_new)
    for g, w, m in zip(got, want, max_new):
        assert g.shape == (m,)
        np.testing.assert_array_equal(g, w)


def test_control_waits_for_the_loop_port(pair):
    """The loop is ported: ``control=True`` builds a ``ControlLoop`` over
    the lanes' service that writes to the engine's ``control_log``, and
    an externally monitored engine still refuses control."""
    from repro_torch.control import ControlLog, ControlLoop
    _, _, tm, tp, _ = pair
    log = ControlLog(8)
    eng = Engine(tm, tp, ServeConfig(), control=True, control_log=log,
                 device="cpu")
    try:
        assert isinstance(eng.control, ControlLoop)
        assert eng.control.service is eng.fleet
        assert eng.control.log is log and eng.control_log is log
    finally:
        eng.stop()
    with pytest.raises(ValueError, match="monitor=False"):
        Engine(tm, tp, ServeConfig(), control=True, monitor=False,
               device="cpu")


def test_engine_parameters_sit_where_the_reference_has_them():
    """``Engine.__init__`` takes the JAX engine's parameters in the JAX
    engine's order (``control_log`` 8th), so a call by position binds
    ``monitor``, ``fault_plan`` and ``obs`` as it does there; the port
    adds ``device`` last."""
    ref = list(inspect.signature(JEngine.__init__).parameters)
    got = list(inspect.signature(Engine.__init__).parameters)
    assert got[:len(ref)] == ref
    assert got[len(ref):] == ["device"]
    assert ref.index("control_log") == 8      # self first


def test_engine_keeps_its_control_log(pair):
    """A log passed by position lands in ``control_log``, and the
    parameters after it bind as in the reference."""
    from repro_torch.control import ControlLog
    _, _, tm, tp, _ = pair
    log = ControlLog(8)
    eng = Engine(tm, tp, ServeConfig(batch_size=B, max_seq=S_MAX), None,
                 None, False, None, log, False, device="cpu")
    try:
        assert eng.control_log is log
        assert eng.fleet is None               # monitor=False, by position
    finally:
        eng.stop()
