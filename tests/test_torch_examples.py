"""The port's example twins (``examples/*_torch.py``) on the CPU, at
small sizes, against the JAX package where an output is deterministic.

* ``streaming_apps_torch``: Fig. 16's streaming matmul at the reference's
  n = 256 equals A @ B from the reference's numpy seeds; Fig. 17's
  Rabin-Karp on a shorter corpus finds exactly the reference's count
  (the corpus length over the pattern's); the fleet and closed-loop
  demos pass every item through.
* ``quickstart_torch``: every item through A -> B.
* ``serve_decode_torch``: the smoke internlm2 model with the JAX
  package's weights (``params_from_numpy``), float32 on both sides:
  every request's greedy tokens equal the reference ``Engine``'s for the
  same requests (equal prompt lengths, so a round's composition does not
  change a row).
* ``train_lm_torch --small``: a few steps, then a second run resumes at
  its own last checkpoint; the trainer is fed the reference
  ``DataPipeline(SyntheticLMSource)``'s batches.

Nothing timed on the host is gated.  Every pipeline and engine is
stopped by the twins themselves.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke
from repro.data import DataPipeline as JDataPipeline
from repro.data import SyntheticLMSource as JSyntheticLMSource
from repro.models import build_model as j_build_model
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model, params_from_numpy
from repro_torch.train import trainer as t_trainer

torch.set_num_threads(1)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _twin(name):
    """Import ``examples/<name>.py`` by path."""
    spec = importlib.util.spec_from_file_location(f"_twin_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def apps():
    return _twin("streaming_apps_torch")


def test_fig16_matmul_equals_a_times_b_from_the_reference_seeds(apps):
    rows, verdict, info = apps.fig16_matmul_app(256, device="cpu")
    A = np.random.default_rng(0).normal(size=(256, 256)).astype(np.float32)
    B = np.random.default_rng(1).normal(size=(256, 256)).astype(np.float32)
    np.testing.assert_array_equal(info["A"], A)
    np.testing.assert_array_equal(info["B"], B)
    np.testing.assert_allclose(info["acc"], A @ B, atol=1e-3)
    assert info["ok"] and info["rows_out"] == 256
    assert rows[0].startswith("fig16_matmul,")
    assert "rows=256_correct=True" in rows[0]
    assert verdict.startswith("matmul correct=True")


@pytest.mark.parametrize("repeats,chunk_len", [(20_000, 4096), (3001, 1000)])
def test_fig17_rabin_karp_finds_the_reference_count(apps, repeats,
                                                    chunk_len):
    rows, verdict, info = apps.fig17_rabin_karp(repeats, chunk_len,
                                                device="cpu")
    expect = len(b"foobar" * repeats) // len(b"foobar")
    assert info["expected"] == expect == repeats
    assert info["matches"] == expect
    n = len(b"foobar" * repeats)
    assert info["chunks"] == len(range(0, n - 6 + 1, chunk_len))
    assert f"matches={expect}_expected~{expect}" in rows[0]
    assert verdict.startswith(f"found {expect}/{expect} matches")


def test_fleet_and_closed_loop_demos_pass_every_item(apps):
    res = apps.fleet_control_demo(3000, device="cpu")
    assert res["out"] == [(x * x, x * x % 7) for x in range(3000)]
    assert list(res["rates"]) == ["src->square", "square->tag", "tag->sink"]
    assert set(res["replicas"]) == {"square", "tag"}
    res = apps.closed_loop_demo(1500, device="cpu")
    assert sorted(res["out"]) == list(range(1, 1501))
    assert res["stats"]["crash_count"] == 0
    assert res["live_replicas"] >= 1


def test_quickstart_passes_every_item():
    qs = _twin("quickstart_torch")
    res = qs.run(items=4000, device="cpu")
    assert res["processed"] == 4000
    assert list(res["rates"]) == ["A->B", "B->sink"]
    assert res["estimate"] >= 0.0 and qs.SET_RATE == 20_000


def test_twins_refuse_a_missing_card(apps, monkeypatch):
    """``--device cuda`` without a card raises; nothing falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        apps.fig16_matmul_app(8, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _twin("serve_decode_torch").serve(requests=1, device="cuda")


def test_serve_decode_tokens_equal_the_reference_engine():
    sd = _twin("serve_decode_torch")
    arch, n = "internlm2-1.8b", 24
    cfg = get_smoke_config(arch)
    jm = j_build_model(j_get_smoke(arch), compute_dtype=jnp.float32)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = build_model(cfg, torch.float32)
    tp = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu", compute_dtype=torch.float32)
    res = sd.serve(arch, n, device="cpu", model=tm, params=tp)
    assert res["served"] == n and res["tokens"] == 8 * n
    assert res["recommended"] >= 1

    # the reference example's requests through the reference engine
    jeng = JEngine(jm, jp, JServeConfig(batch_size=4, max_seq=64,
                                        queue_capacity=16)).start()
    try:
        rng = np.random.default_rng(0)
        jreqs = [JRequest(rid=i, tokens=rng.integers(0, cfg.vocab_size,
                                                     size=8), max_new=8)
                 for i in range(n)]
        for r in jreqs:
            jeng.submit(r)
        for r in jreqs:
            assert r.done.wait(timeout=300)
    finally:
        jeng.stop()
    for got, want in zip(res["reqs"], jreqs):
        np.testing.assert_array_equal(got.tokens, want.tokens)
        np.testing.assert_array_equal(np.asarray(got.out),
                                      np.asarray(want.out))


def test_train_lm_small_resumes_and_takes_the_reference_batches(
        tmp_path, monkeypatch):
    tl = _twin("train_lm_torch")
    seen = []
    fit = t_trainer.Trainer.fit

    def recording_fit(self, data_iter, steps):
        def tee():
            for b in data_iter:
                seen.append({k: np.array(v) for k, v in b.items()})
                yield b
        return fit(self, tee(), steps)
    monkeypatch.setattr(t_trainer.Trainer, "fit", recording_fit)
    kw = dict(batch=2, seq=32, ckpt=str(tmp_path / "ckpt"), small=True,
              device="cpu", ckpt_every=2, log_every=2)
    first = tl.train(4, **kw)
    assert first["cfg"].n_layers == 4 and first["cfg"].vocab_size == 4096
    assert first["start"] == 0
    assert [h["step"] for h in first["history"]] == [2, 4]
    assert all(np.isfinite(h["loss"]) for h in first["history"])
    assert first["ckpt_steps"] == [2, 4]
    assert list(first["rates"]) == ["pack->batch", "batch->device"]

    # the batches the trainer took are the reference pipeline's
    jdp = JDataPipeline(JSyntheticLMSource(4096, doc_len=512), seq_len=32,
                        batch_size=2, queue_capacity=8,
                        max_batches=4 + 8).start()
    try:
        it = iter(jdp)
        want = [next(it) for _ in range(4)]
    finally:
        jdp.stop()
    assert len(seen) >= 4
    for got, ref in zip(seen[:4], want):
        for k in ("tokens", "targets"):
            np.testing.assert_array_equal(got[k], np.asarray(ref[k]))

    second = tl.train(2, **kw)
    assert second["start"] == 4
    assert [h["step"] for h in second["history"]] == [6]
    assert second["ckpt_steps"] == [2, 4, 6]

