"""Training data pipeline over the instrumented streaming substrate.

reader -> tokenize/pack -> batch -> (host) prefetch queue -> device

Every link is an InstrumentedQueue, so the paper's monitor sees the real
arrival/service rates and the controllers can (a) size the prefetch buffer
analytically and (b) decide reader replication — the paper's two
motivating optimizations, applied to an LM training job.  The links'
monitor service runs on ``device`` (the card by default); the tokens
stay numpy on the host.
"""

from __future__ import annotations

import threading
from typing import Iterator, Optional

import numpy as np

from repro_torch.core.device import resolve_device
from repro_torch.core.monitor import MonitorConfig
from repro_torch.streams import (CounterArena, FleetMonitorService,
                                 FleetMonitorThread, InstrumentedQueue, STOP)

__all__ = ["SyntheticLMSource", "TextFileSource", "DataPipeline",
           "pack_tokens"]


class SyntheticLMSource:
    """Deterministic synthetic token stream (zipfian unigrams + markov
    bigram mixing) — self-contained stand-in for a real corpus shard."""

    def __init__(self, vocab_size: int, doc_len: int = 512, seed: int = 0):
        self.vocab = vocab_size
        self.doc_len = doc_len
        self.rng = np.random.default_rng(seed)
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        self.p = (1.0 / ranks) / np.sum(1.0 / ranks)

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            doc = self.rng.choice(self.vocab, size=self.doc_len, p=self.p)
            yield doc.astype(np.int32)


class TextFileSource:
    """Byte-level tokenization of a real file, streamed in chunks."""

    def __init__(self, path: str, chunk: int = 4096, repeat: bool = True):
        self.path, self.chunk, self.repeat = path, chunk, repeat

    def __iter__(self):
        while True:
            with open(self.path, "rb") as f:
                while True:
                    raw = f.read(self.chunk)
                    if not raw:
                        break
                    yield np.frombuffer(raw, dtype=np.uint8).astype(
                        np.int32)
            if not self.repeat:
                return


def pack_tokens(docs: Iterator[np.ndarray], seq_len: int,
                eos: int = 0) -> Iterator[np.ndarray]:
    """Pack documents into fixed (seq_len+1,) windows (input+target)."""
    buf = np.empty(0, dtype=np.int32)
    for doc in docs:
        buf = np.concatenate([buf, doc, np.array([eos], np.int32)])
        while len(buf) >= seq_len + 1:
            yield buf[:seq_len + 1].copy()
            buf = buf[seq_len + 1:]


class DataPipeline:
    """Instrumented host pipeline producing {tokens, targets} batches."""

    def __init__(self, source, seq_len: int, batch_size: int,
                 queue_capacity: int = 16, n_readers: int = 1,
                 monitor_cfg: Optional[MonitorConfig] = None,
                 max_batches: Optional[int] = None,
                 arena: Optional[CounterArena] = None, *,
                 device="cuda"):
        self.device = resolve_device(device)
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.max_batches = max_batches
        self.q_seq = InstrumentedQueue(queue_capacity * batch_size,
                                       item_bytes=4 * (seq_len + 1),
                                       name="pack->batch", arena=arena)
        self.q_batch = InstrumentedQueue(
            queue_capacity, item_bytes=4 * (seq_len + 1) * batch_size,
            name="batch->device", arena=arena)
        cfg = monitor_cfg or MonitorConfig(window=16, min_q_samples=16)
        # both links ride the one fleet dispatch per tick
        self.fleet = FleetMonitorService([self.q_seq, self.q_batch], cfg,
                                         period_s=5e-3, chunk_t=16,
                                         ends="both", device=self.device)
        self.monitor_thread = FleetMonitorThread(self.fleet)
        self._threads: list[threading.Thread] = []
        self._source = source
        self._n_readers = n_readers
        self._stopped = threading.Event()

    def _reader(self, shard: int):
        packed = pack_tokens(iter(self._source), self.seq_len)
        for seq in packed:
            # push in short waits, so that ``stop`` ends a reader held
            # by a full queue (once the batcher is done, nothing drains
            # it): a reader left retrying its push takes the GIL ~1000
            # times a second for as long as the process lives
            while not self.q_seq.push(seq, timeout=0.05):
                if self._stopped.is_set():
                    return
            if self._stopped.is_set():
                return

    def _batcher(self):
        n = 0
        while not self._stopped.is_set():
            seqs = [self.q_seq.pop(timeout=10.0)
                    for _ in range(self.batch_size)]
            if any(s is None for s in seqs):
                break
            arr = np.stack(seqs)
            self.q_batch.push({"tokens": arr[:, :-1],
                               "targets": arr[:, 1:]})
            n += 1
            if self.max_batches and n >= self.max_batches:
                break
        self.q_batch.push(STOP)

    def start(self):
        self.monitor_thread.start()
        for i in range(self._n_readers):
            t = threading.Thread(target=self._reader, args=(i,),
                                 daemon=True, name=f"reader-{i}")
            t.start()
            self._threads.append(t)
        t = threading.Thread(target=self._batcher, daemon=True,
                             name="batcher")
        t.start()
        self._threads.append(t)
        return self

    def __iter__(self):
        while True:
            item = self.q_batch.pop(timeout=60.0)
            if item is None or item is STOP:
                return
            yield item

    def stop(self):
        self._stopped.set()
        self.monitor_thread.stop()

    def rates(self) -> dict:
        mu = self.fleet.service_rates()
        lam = self.fleet.arrival_rates()
        eps = self.fleet.epochs()
        q = len(self.fleet)
        return {queue.name: {
            "service_rate": float(mu[i]),
            "arrival_rate": float(lam[i]),
            "epochs": int(eps[i] + eps[q + i]),
        } for i, queue in enumerate(self.fleet.queues)}
