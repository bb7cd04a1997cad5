"""The port's token data pipeline (``repro_torch.data``) against the JAX
package's (``repro.data``), on the CPU.

``pack_tokens`` must cut exact windows; the synthetic source must draw
the reference's documents from the same seed; a ``DataPipeline`` (one
reader, its two links on one fleet dispatch, the service on the CPU)
must yield the reference's batches for the same source seed, and its
readout must carry the Welford-count gate.  ``stop`` ends every thread
the pipeline started, a reader held by a full queue included.
"""

import time

import numpy as np
import pytest
import torch

import repro.data as j_data
import repro_torch.data as t_data
from repro_torch.core import device as t_device
from repro_torch.streams import CounterArena

torch.set_num_threads(1)


def test_pack_tokens_exact_windows():
    docs = [np.arange(10, dtype=np.int32),
            np.arange(100, 120, dtype=np.int32)]
    seqs = list(t_data.pack_tokens(iter(docs), seq_len=7))
    assert all(s.shape == (8,) for s in seqs)
    flat = np.concatenate(seqs)
    # first doc then EOS(0) then second doc
    np.testing.assert_array_equal(flat[:10], np.arange(10))
    assert flat[10] == 0
    np.testing.assert_array_equal(flat[11:24], np.arange(100, 113))
    want = list(j_data.pack_tokens(iter(docs), seq_len=7))
    assert len(seqs) == len(want) == 4      # 10 + EOS + 20 + EOS tokens
    for a, b in zip(seqs, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seq_len,eos", [(5, 0), (31, 7), (64, 3)])
def test_pack_tokens_equals_the_reference(seq_len, eos):
    rng = np.random.default_rng(seq_len)
    docs = [rng.integers(1, 50, rng.integers(1, 90)).astype(np.int32)
            for _ in range(40)]
    got = list(t_data.pack_tokens(iter(docs), seq_len, eos=eos))
    want = list(j_data.pack_tokens(iter(docs), seq_len, eos=eos))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_synthetic_source_equals_the_reference():
    got = iter(t_data.SyntheticLMSource(vocab_size=1000, doc_len=96, seed=3))
    want = iter(j_data.SyntheticLMSource(vocab_size=1000, doc_len=96,
                                         seed=3))
    for _ in range(6):
        a, b = next(got), next(want)
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_text_file_source_equals_the_reference(tmp_path):
    path = tmp_path / "corpus.txt"
    path.write_bytes(bytes(range(256)) * 9)
    got = list(t_data.TextFileSource(str(path), chunk=1000, repeat=False))
    want = list(j_data.TextFileSource(str(path), chunk=1000, repeat=False))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _batches(data, **kw):
    src = data.SyntheticLMSource(vocab_size=100, doc_len=64, seed=0)
    dp = data.DataPipeline(src, seq_len=32, batch_size=4, max_batches=5,
                           arena=CounterArena(8) if data is t_data else None,
                           **kw).start()
    try:
        return list(dp), dp
    finally:
        dp.stop()


def test_data_pipeline_batches_equal_the_reference():
    got, dp = _batches(t_data, device="cpu")
    want, _ = _batches(j_data)
    assert len(got) == len(want) == 5
    for b, r in zip(got, want):
        assert b["tokens"].shape == (4, 32)
        assert b["targets"].shape == (4, 32)
        np.testing.assert_array_equal(b["tokens"][:, 1:],
                                      b["targets"][:, :-1])
        assert b["tokens"].max() < 101
        np.testing.assert_array_equal(b["tokens"], r["tokens"])
        np.testing.assert_array_equal(b["targets"], r["targets"])
    assert not dp.monitor_thread.is_alive()
    assert dp.fleet.device.type == "cpu"
    rates = dp.rates()
    assert list(rates) == ["pack->batch", "batch->device"]
    # the gated readout: the converged q-bar, else the running q-bar
    # once min_q_samples folds accumulated, else 0 (heads, then tails)
    st = dp.fleet.state_snapshot()
    cfg = dp.fleet.cfg
    gated = np.where(st.epoch > 0, st.last_qbar,
                     np.where(st.count >= cfg.min_q_samples, st.mean, 0.0))
    gated = gated / dp.fleet.period_s
    for i, r in enumerate(rates.values()):
        assert r["service_rate"] == pytest.approx(gated[i], rel=1e-12)
        assert r["arrival_rate"] == pytest.approx(gated[2 + i], rel=1e-12)
        assert r["epochs"] == int(st.epoch[i] + st.epoch[2 + i])


def test_stop_ends_a_reader_held_by_a_full_queue():
    """After ``max_batches`` the batcher stops draining the sequence
    queue, so the reader fills it and waits on its push; ``stop`` must
    end it (a reader left retrying would take the GIL ~1000 times a
    second for the life of the process)."""
    src = t_data.SyntheticLMSource(vocab_size=50, doc_len=40, seed=0)
    dp = t_data.DataPipeline(src, seq_len=8, batch_size=2,
                             queue_capacity=2, max_batches=1,
                             device="cpu").start()
    assert len(list(dp)) == 1
    deadline = time.monotonic() + 5.0
    while len(dp.q_seq) < dp.q_seq.capacity and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(dp.q_seq) == dp.q_seq.capacity     # the reader is held
    dp.stop()
    for t in dp._threads:
        t.join(timeout=2.0)
        assert not t.is_alive(), t.name
    assert not dp.monitor_thread.is_alive()


def test_data_pipeline_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(t_device.torch.cuda, "is_available", lambda: False)
    src = t_data.SyntheticLMSource(vocab_size=10, doc_len=8, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_data.DataPipeline(src, seq_len=4, batch_size=2)
