"""Fleet monitor service: one dispatch per pipeline tick, any fleet size.

This is the single monitoring hot path for the whole stack
(``streams.Pipeline``, ``serve.Engine``, ``data.DataPipeline``).  The
paper instruments each queue with its own host-side Algorithm-1 update
per period; at fleet scale that per-queue python math blows the 1-2%
overhead budget.  Here the timer tick only runs the *batched collector*:
every monitored end is a slot view into one shared ``CounterArena``
(contiguous (S,) ``tc``/``blocked``/``bytes_count`` arrays), and the
tick copies-and-zeros the whole fleet in a handful of vectorized ops —
one gather with a fused period-scale into the active staging row, one
boolean copy, one zero-fill — with **no per-end python iteration** (the
10^5-queue step).  Two layout choices keep those ops at memcpy speed:

* staging rows are *slot-sorted*: internal row order follows arena slot
  order, so a co-allocated fleet's gather and zero-fill collapse to
  plain slice views (readouts translate back to the public
  heads-then-tails stream order through a permutation, off the tick).
  ``serve.Engine``'s per-QoS-class lanes lean on this: the engine
  reserves one contiguous slot span (``CounterArena.reserve_span``)
  for all its lane ends, so per-class λ/μ estimates ride the same
  gather at zero added collector cost;
* the staging tile is (chunk_t, S) row-major, so each tick writes one
  contiguous row; it goes to the card as it is, and the estimator reads
  its ``.T`` view, a time-major (S, chunk_t) tile (the kernel's loads of
  one step are then neighbouring addresses; no transpose-copy).

Every ``chunk_t`` periods the full tile goes through **one** donated
``run_monitor_fleet`` dispatch — one launch of the fused CUDA kernel,
which updates the device-resident fleet state in place — that advances
Algorithm 1 for every stream at once.  The tile travels to the card
through a pinned host buffer with a non-blocking copy:

    collector -> double buffer -> fused fleet dispatch -> vectorized
    controllers (BufferAutotuner / ParallelismController /
    StragglerDetector / DistributionClassifier fleet forms)

Two things keep the dispatch off the tick's critical path:

* **Double buffering** — two staging buffers swap at dispatch time, so
  collection continues into one while the previous tile's dispatch
  (asynchronous on the card) still computes from the other.
* **Deferred harvest** — right after a dispatch, non-blocking copies of
  its epochs/estimates/counts into pinned host buffers are queued and a
  CUDA event is recorded behind them; the *next* dispatch (or
  ``flush()``) waits on that event and reads the buffers, so the timer
  thread never blocks on device results it does not yet need.

The dispatch updates the device-resident state in place with no queue
padding (the kernel needs none, and the padding would copy the state
every dispatch); the kernel is built and first launched by
``warmup()``, off the sampling tick.

With ``ends="both"`` each queue contributes two monitored streams —
head (consumer / service rate) first, then tail (producer / arrival
rate) — which is what the run-time controllers need to size buffers and
replicas.  Estimates come back through the Welford-count-gated
``service_rates()`` / ``arrival_rates()`` readouts and the batched
``on_fleet(indices, rates)`` convergence callback (a scalar per-stream
``on_converged(i, rate)`` is kept for compatibility).

The same chunk cadence also harvests the **SLO plane**
(``_refresh_slo_locked``, run at dispatch/flush — never on the per-tick
hot path): latency-percentile / error-rate windows are formed by
differencing the arena's *cumulative* ``lat_hist`` / ``err_count`` /
``lat_count`` columns against per-service mirrors.  The harvest is
count-gated — it gathers only the (S,) ``lat_count`` scalars every
window and pays for full (B,)-row histogram traffic ONLY on slots whose
count moved, so an idle fleet costs O(S) and a 1%-hot fleet stays a few
percent of the collector tick even at S=2e5.  Readouts are
``latency_percentiles()`` / ``latency_counts()`` / ``error_totals()`` /
``error_rates()`` / ``over_fraction()`` (the control loop's burn-rate
sense input) and the exporter's single-lock ``obs_snapshot()``.

Lock ordering: ``self._lock`` sits at the *service* rank of the lock
hierarchy, one above the arena.  The collector tick takes ``self._lock``
then ``arena.lock`` (declared order) and releases both before firing
callbacks; readouts take ``self._lock`` alone; the *sync*-tier leaves
(queue resize, stage stop) are never held while acquiring either.  A
``ControlLoop`` tick mid-actuation holds only its own (higher) rank
plus briefly a leaf, so ``stop()``/``flush()`` from any thread
serialize cleanly against it — they can interleave with an actuation
but never deadlock or observe a half-written staging row.  The
multi-tenant restructure (``attach``/``detach``) takes the same
service -> arena order under the group/loop ranks above, so it
serializes against the collector tick like any readout.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.controller import DistributionClassifier
from repro_torch.core.monitor import (FleetMonitorState, MonitorConfig,
                                      fleet_monitor_init, fleet_rate_readout,
                                      gated_rate_arrays, resolve_device,
                                      run_monitor_fleet)
from repro_torch.streams.arena import (LAT_BUCKETS, default_arena,
                                       hist_over_fraction, hist_quantiles)
from repro_torch.streams.queue import InstrumentedQueue

__all__ = ["FleetMonitorService"]


def _pick_block_q(n_streams: int) -> int:
    """Smallest power-of-two block covering the fleet, capped at 256:
    ragged fleet sizes pad up to one shared dispatch shape."""
    return min(256, 1 << max(1, (max(n_streams, 1) - 1).bit_length()))


class FleetMonitorService:
    """Batched Algorithm-1 monitoring for a fleet of instrumented queues.

    ``sample()`` is the per-tick collector — a constant number of
    vectorized arena ops regardless of fleet size, safe to call from a
    timer thread, with no per-end python loop and no estimator math.
    The fused estimator runs as one donated dispatch per ``chunk_t``
    ticks (or in ``flush()``), with results harvested one dispatch
    behind so the collector never waits on the device.

    All monitored queues must back into one ``CounterArena`` (the
    default process-wide arena makes this automatic).  The estimator
    state lives on ``device`` — the card by default; ``device="cpu"``
    runs the kernel's plain PyTorch version on the host.
    """

    # harvested quantiles (p50/p90/p99/p999), column order of
    # ``latency_percentiles()``
    _QS = (0.5, 0.9, 0.99, 0.999)

    def __init__(self, queues: Sequence[InstrumentedQueue],
                 cfg: Optional[MonitorConfig] = None, *,
                 period_s: float = 1e-3, chunk_t: int = 32,
                 impl: str = "cuda", scale_to_period: bool = True,
                 ends: str = "head", block_q: Optional[int] = None,
                 arena=None,
                 on_converged: Optional[Callable] = None,
                 on_fleet: Optional[Callable] = None,
                 device="cuda"):
        if ends not in ("head", "both"):
            raise ValueError(f"bad ends {ends!r}")
        self.device = resolve_device(device)
        self.queues = list(queues)
        self.cfg = cfg or MonitorConfig()
        self.period_s = float(period_s)
        self.chunk_t = int(chunk_t)
        self.impl = impl
        # rescale counts by realized/nominal period so timer drift does
        # not alias into the rate (disable when periods are synthetic)
        self.scale_to_period = scale_to_period
        self.ends = ends
        self.on_converged = on_converged
        self.on_fleet = on_fleet

        q = len(self.queues)
        # stream layout: heads (0..Q-1), then tails (Q..2Q-1) if "both"
        self._end_stats = self._ends_of(self.queues)
        s = len(self._end_stats)
        self.n_streams = s
        # the JAX package's queue-padding block, kept for its signature:
        # the port's dispatch pads nothing
        self.block_q = int(block_q) if block_q else _pick_block_q(s)

        # ``arena`` seeds the empty-fleet case (a ControlGroup's service
        # is born with no queues but must land in the group's arena);
        # once ends exist their shared arena is authoritative and an
        # explicit mismatch is rejected like any mixed-arena fleet
        self._arena = self._single_arena(self._end_stats, arena)
        if (arena is not None and self._end_stats
                and self._arena is not arena):
            raise ValueError(
                "explicit arena= does not match the queues' arena")
        # once an arena is pinned (explicitly seeded, or implied by the
        # first monitored ends) a later attach may not silently re-home
        # the service; only a bare empty service keeps the door open
        self._arena_pinned = arena is not None or bool(self._end_stats)
        # pin the monitored ends: releasing a slot we keep gathering
        # would hand it to a new owner whose counters we then zero
        for end in self._end_stats:
            end._pins.add(self)
        self._derive_layout()

        self._state: FleetMonitorState = fleet_monitor_init(
            self.cfg, s, device=self.device)
        self._event = None     # recorded behind the last dispatch's reads
        # double-buffered (chunk_t, S) host staging, row-major so each
        # tick writes one contiguous row; the active pair collects while
        # the shadow pair backs the in-flight dispatch
        self._alloc_staging()
        self._pending = False          # a dispatch awaits harvest
        self._init_mirrors()
        self.dispatches = 0
        # per-queue service-process moments (cv^2 feeds buffer sizing)
        self.classifier = DistributionClassifier(n_streams=q)
        self._lock = threading.Lock()
        self._last_t: Optional[float] = None   # set on first sample()
        self._stopped = False

    def _ends_of(self, queues) -> list:
        ends = [qu.head for qu in queues]
        if self.ends == "both":
            ends += [qu.tail for qu in queues]
        return ends

    @staticmethod
    def _single_arena(ends, fallback):
        # every monitored end must back into ONE arena: the collector is
        # a single gather/zero over that arena's (S,) counter arrays
        arenas = {id(end.arena): end.arena for end in ends}
        if len(arenas) > 1:
            raise ValueError(
                "all monitored queues must share one CounterArena "
                f"(got {len(arenas)})")
        if arenas:
            return next(iter(arenas.values()))
        return fallback if fallback is not None else default_arena()

    def _derive_layout(self) -> None:
        """(Re)derive the slot permutation from a consistent
        (slots, layout_version) arena snapshot — see
        ``CounterArena.snapshot_slots`` for why the pair must be one
        read.  Internal row order = slot-sorted: row r stages the
        stream ``_stream_of_row[r]``, stream i lives at row
        ``_row_of_stream[i]``.  A co-allocated fleet's sorted slots form
        one contiguous run, collapsing the per-tick gather/zero to plain
        slice views."""
        slots, self._layout_version = \
            self._arena.snapshot_slots(self._end_stats)
        perm = np.argsort(slots, kind="stable")
        self._stream_of_row = perm
        self._row_of_stream = np.argsort(perm, kind="stable")
        self._slots = self._slice_or_index(slots[perm])

    def _alloc_staging(self) -> None:
        s = self.n_streams
        self._tc = np.zeros((self.chunk_t, s))
        self._blocked = np.ones((self.chunk_t, s), dtype=bool)
        self._tc_shadow = np.zeros_like(self._tc)
        self._blk_shadow = np.ones_like(self._blocked)
        self._col = 0
        # pinned host buffers on the card's path: the (S, cols) tile goes
        # up through them with a non-blocking copy, and the harvest reads
        # come back through them.  One set suffices — every dispatch
        # waits (harvest) on the previous dispatch's event before it
        # rewrites them, and that event stands behind both copies.
        pin = self.device.type == "cuda"

        def buf(n, dtype):
            return torch.empty((n,), dtype=dtype, pin_memory=pin)

        self._pin_tc = buf(s * self.chunk_t, torch.float32)
        self._pin_blk = buf(s * self.chunk_t, torch.bool)
        self._pin_out = {name: buf(s, dtype) for name, dtype in (
            ("epoch", torch.int32), ("last_qbar", torch.float32),
            ("count", torch.float32), ("mean", torch.float32),
            ("n_blocked", torch.int32), ("n_total", torch.int32))}

    def _init_mirrors(self) -> None:
        # numpy mirrors of the gate leaves, refreshed at harvest time:
        # the control loop's sense step reads these instead of paying
        # per-tick device->host copies (estimates only move when a
        # dispatch harvests anyway)
        s = self.n_streams
        self._epochs = np.zeros((s,), np.int64)
        self._count_np = np.zeros((s,))
        self._mean_np = np.zeros((s,))
        self._qbar_np = np.zeros((s,))
        self._nblk_np = np.zeros((s,), np.int64)
        self._ntot_np = np.zeros((s,), np.int64)
        # SLO-plane mirrors (internal row order, refreshed once per
        # dispatch by ``_refresh_slo_locked``).  The arena's latency
        # histograms / error counters are CUMULATIVE — the service never
        # zeroes them; it differences per-chunk gathers against the
        # ``*_prev`` snapshots, so the per-tick collector cost is
        # untouched and two services could in principle window the same
        # ends independently.
        self._pctl_np = np.full((s, len(self._QS)), np.nan)
        self._err_rate_np = np.zeros((s,))
        self._err_total_np = np.zeros((s,), np.int64)
        self._lat_count_np = np.zeros((s,), np.int64)
        # the last chunk window's histogram, SPARSE: (C,) internal rows
        # that saw observations + their (C, B) window rows.  Dense (s, B)
        # storage would cost an O(s*B) allocate-and-zero per harvest —
        # at s=2e5 that alone is several ms, dwarfing the collector tick
        # — while the window is by construction supported only on the
        # slots the change detector fired on.  Published by replacement
        # (both arrays swapped together under the lock), never mutated.
        self._win_idx = np.empty((0,), np.intp)
        self._win_hist = np.empty((0, LAT_BUCKETS), np.int64)
        self._hist_prev = np.zeros((s, LAT_BUCKETS), np.int64)
        self._err_prev = np.zeros((s,), np.int64)
        # (S,) observation-count snapshot: the cheap change detector
        # that keeps the harvest from re-gathering every (B,) histogram
        # row of a mostly-idle fleet each window
        self._cnt_prev = np.zeros((s,), np.int64)
        self._slo_t: Optional[float] = None

    def __len__(self) -> int:
        return len(self.queues)

    @staticmethod
    def _slice_or_index(sorted_slots: np.ndarray):
        """A contiguous ascending slot run collapses the per-tick
        gather/zero to plain slice views; anything else gathers."""
        s = len(sorted_slots)
        if s and np.array_equal(sorted_slots,
                                np.arange(sorted_slots[0],
                                          sorted_slots[0] + s)):
            return slice(int(sorted_slots[0]), int(sorted_slots[0]) + s)
        return sorted_slots

    def _rebind_slots_locked(self) -> None:
        """Re-derive the cached slot index after the arena moved slots
        (defragmentation).  Called with ``arena.lock`` held, so the new
        layout cannot shift again mid-rebind.  Compaction is
        order-preserving, so the public<->row permutation is invariant —
        only the slot numbers (and slice-ness) change; a fleet that
        regained contiguity rides the slice fast path from this tick on.
        """
        slots = np.array([end.slot for end in self._end_stats], np.intp)
        self._slots = self._slice_or_index(slots[self._stream_of_row])
        self._layout_version = self._arena.layout_version

    def warmup(self) -> None:
        """Build the kernel and launch the fused dispatch once on a
        throwaway state of the same padded shape.  ``FleetMonitorThread``
        calls this before its first tick — the nvcc build (seconds) and
        the first launch must never land on the sampling tick, where they
        would eat the whole observation budget."""
        self._warm_compile()
        with self._lock:
            self._discard_counters_locked()

    def _warm_compile(self) -> None:
        """The throwaway warm-up dispatch (lock-free; shared by
        ``warmup`` and the attach/detach restructure)."""
        if self.n_streams:
            dev = self.device
            run_monitor_fleet(            # the dispatch's time-major tile
                self.cfg,
                torch.zeros((self.chunk_t, self.n_streams), device=dev).T,
                torch.ones((self.chunk_t, self.n_streams), dtype=torch.bool,
                           device=dev).T,
                state=fleet_monitor_init(self.cfg, self.n_streams,
                                         device=dev),
                chunk_t=self.chunk_t, impl=self.impl, mode="state",
                donate=True, pad_q=False, device=dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def _discard_counters_locked(self) -> None:
        """Zero every monitored cell and reset the realized-period
        clock (``self._lock`` held): the next tick must not fold the
        preceding compile/rebuild interval as one nominal period."""
        arena = self._arena
        with arena.lock:
            if arena.layout_version != self._layout_version:
                self._rebind_slots_locked()
            idx = self._slots
            arena.tc[idx] = 0.0
            arena.blocked[idx] = False
            arena.bytes_count[idx] = 0
            # the latency/error columns are cumulative (other readers —
            # Engine.latency_stats — share them), so discard means
            # re-baselining the window snapshots, not zeroing the cells
            self._hist_prev = np.array(arena.lat_hist[idx], np.int64)
            self._err_prev = np.array(arena.err_count[idx], np.int64)
            self._cnt_prev = np.array(arena.lat_count[idx], np.int64)
        self._last_t = time.monotonic()
        self._slo_t = None

    # -- sampling ---------------------------------------------------------
    def sample(self) -> bool:
        """Copy-and-zero every monitored end's counters for this period.

        Returns True if any end observed blocking this tick — the signal
        the shared sampling-period controller consumes.
        """
        now = time.monotonic()
        realized = None if self._last_t is None else now - self._last_t
        self._last_t = now
        scale = 1.0    # first tick: no realized period to rescale by
        if self.scale_to_period and realized is not None and realized > 0:
            scale = self.period_s / realized
        emit = ()
        arena = self._arena
        with self._lock:
            if self._stopped:
                return False
            col = self._col
            tc_row = self._tc[col]
            blk_row = self._blocked[col]
            # vectorized copy-and-zero of the whole fleet: one gather
            # with a fused scale into the contiguous staging row, one
            # boolean copy, one zero-fill — no per-end python iteration
            # (all three are slice views for co-allocated fleets).  The
            # arena lock bounds the copy-and-zero window against
            # structural growth; cell increments stay lock-free (the
            # paper's tolerated single-period race).
            with arena.lock:
                if arena.layout_version != self._layout_version:
                    self._rebind_slots_locked()   # slots moved (defrag)
                idx = self._slots
                np.multiply(arena.tc[idx], scale, out=tc_row)
                np.copyto(blk_row, arena.blocked[idx])
                arena.tc[idx] = 0.0
                arena.blocked[idx] = False
                arena.bytes_count[idx] = 0
            any_blocked = bool(blk_row.any())
            self._col = col + 1
            if self._col >= self.chunk_t:
                emit = self._dispatch_locked()
        self._fire(emit)
        return any_blocked

    def flush(self) -> None:
        """Dispatch any buffered partial chunk and harvest everything.
        Idempotent, and safe to call from any thread at any time — in
        particular while a ``ControlLoop`` tick is mid-actuation (the
        tick holds no service lock during actuation; see the module
        docstring's lock-ordering audit)."""
        emits = []
        with self._lock:
            if self._col:
                emits.append(self._dispatch_locked())
            else:
                self._refresh_slo_locked()
            emits.append(self._harvest_locked())
        for emit in emits:
            self._fire(emit)

    def stop(self) -> None:
        """Flush, then permanently quiesce the service (idempotent).

        After ``stop()`` the collector tick is a no-op, readouts keep
        serving the final state, and the monitored ends are un-pinned so
        their queues may ``close()`` and recycle their arena slots.
        Safe concurrently with a control tick mid-actuation: actuators
        touch only leaf locks, never the service lock this takes."""
        self.flush()
        with self._lock:
            self._stopped = True
        for end in self._end_stats:
            end._pins.discard(self)

    # -- live fleet restructure (multi-tenant attach/detach) --------------
    def attach(self, queues: Sequence[InstrumentedQueue]) -> None:
        """Add queues to the monitored fleet, live.  The buffered
        partial chunk is dispatched and harvested first, then every
        per-stream structure (staging, permutation, Algorithm-1 state,
        gate mirrors, classifier moments) is rebuilt — retained streams
        keep their full estimator state, so attaching tenant B never
        resets tenant A's estimates.  Public stream order stays
        heads-then-tails with the new queues appended after the
        existing ones.  The warm-up dispatch at the new size runs in
        the closing restructure, off the sampling tick."""
        queues = list(queues)
        live = {id(q) for q in self.queues}
        if (any(id(q) in live for q in queues)
                or len({id(q) for q in queues}) != len(queues)):
            # a double-attached queue would be gathered into two staging
            # rows per tick — both read the full count before the
            # zero-fill, double-counting every rate — and a later
            # detach of one alias would desync its sibling
            raise ValueError("queue is already monitored by this service")
        self._restructure(self.queues + queues)

    def detach(self, queues: Sequence[InstrumentedQueue]) -> None:
        """Remove queues from the monitored fleet, live (order of the
        remaining queues is preserved).  Their ends are un-pinned, so
        the owner may ``close()`` them and recycle the arena slots."""
        drop = {id(q) for q in queues}
        self._restructure([q for q in self.queues if id(q) not in drop])

    def _restructure(self, new_queues: list) -> None:
        emits = []
        with self._lock:
            if self._stopped:
                raise RuntimeError("cannot restructure a stopped "
                                   "FleetMonitorService")
            # validate the new fleet (single arena) BEFORE touching any
            # state — including the staged chunk: a rejected attach
            # must leave the service intact AND must not have folded
            # (and silently swallowed the emits of) the partial tile
            new_queues = list(new_queues)
            ends = self._ends_of(new_queues)
            s = len(ends)
            arena = self._single_arena(ends, self._arena)
            if self._arena_pinned and ends and arena is not self._arena:
                raise ValueError(
                    "attached queues' arena does not match the "
                    "service's (pass the service's arena to the "
                    "queues, or the queues' arena at construction)")

            # fold everything staged so far into the state: the staging
            # tile is about to be re-shaped, and a half-chunk must not
            # be lost across the restructure
            if self._col:
                emits.append(self._dispatch_locked())
            emits.append(self._harvest_locked())

            old_queues, old_ends = self.queues, self._end_stats
            old_state = [leaf.cpu().numpy() for leaf in self._state]
            old_mirrors = (self._epochs, self._count_np, self._mean_np,
                           self._qbar_np, self._nblk_np, self._ntot_np,
                           self._pctl_np, self._err_rate_np,
                           self._err_total_np, self._lat_count_np)
            old_win_idx, old_win_hist = self._win_idx, self._win_hist
            old_row = {id(end): int(self._row_of_stream[i])
                       for i, end in enumerate(old_ends)}

            self.queues = new_queues
            self._arena = arena
            # pin new before un-pinning old: an end present in both sets
            # must never be observably un-pinned mid-restructure
            for end in ends:
                end._pins.add(self)
            new_ids = {id(end) for end in ends}
            for end in old_ends:
                if id(end) not in new_ids:
                    end._pins.discard(self)
            self._end_stats = ends
            self.n_streams = s
            if ends:
                self._arena_pinned = True
            self._derive_layout()

            # carry Algorithm-1 state + gate mirrors for retained
            # streams into their new internal rows; fresh streams start
            # from the neutral init state
            src = np.full(s, -1, np.intp)      # old row per new row
            for i, end in enumerate(ends):
                r_old = old_row.get(id(end))
                if r_old is not None:
                    src[self._row_of_stream[i]] = r_old
            keep = src >= 0

            def remap(new_leaf, old_leaf):
                a = new_leaf.cpu().numpy().copy()
                if keep.any():
                    a[keep] = old_leaf[src[keep]]
                return torch.as_tensor(a, device=self.device)

            init = fleet_monitor_init(self.cfg, s, device="cpu")
            self._state = FleetMonitorState(
                *(remap(n, o) for n, o in zip(init, old_state)))
            self._init_mirrors()
            for mirror, old in zip(
                    (self._epochs, self._count_np, self._mean_np,
                     self._qbar_np, self._nblk_np, self._ntot_np,
                     self._pctl_np, self._err_rate_np,
                     self._err_total_np, self._lat_count_np),
                    old_mirrors):
                if keep.any():
                    mirror[keep] = old[src[keep]]
            if keep.any() and old_win_idx.size:
                # re-key the sparse window support: a retained stream
                # whose old row was in the support keeps its window row
                # at its new position; dropped streams fall out with it
                old_pos = np.full(old_mirrors[0].shape[0], -1, np.intp)
                old_pos[old_win_idx] = np.arange(old_win_idx.size,
                                                 dtype=np.intp)
                new_rows = np.flatnonzero(keep)
                hit = old_pos[src[new_rows]] >= 0
                self._win_idx = np.array(new_rows[hit], np.intp)
                self._win_hist = old_win_hist[
                    old_pos[src[new_rows[hit]]]]
            # (_hist_prev/_err_prev are re-baselined from the live arena
            # by _discard_counters_locked below, not carried: retained
            # streams simply start a fresh window at the restructure)
            self._alloc_staging()
            # per-queue classifier moments follow their queues
            old_q_idx = {id(qu): i for i, qu in enumerate(old_queues)}
            new_cls = DistributionClassifier(n_streams=len(self.queues))
            qsrc = np.array([old_q_idx.get(id(qu), -1)
                             for qu in self.queues], np.intp)
            qkeep = qsrc >= 0
            if qkeep.any():
                for new_leaf, old_leaf in zip(new_cls._m,
                                              self.classifier._m):
                    np.asarray(new_leaf)[qkeep] = \
                        np.asarray(old_leaf)[qsrc[qkeep]]
            self.classifier = new_cls
            # (convergence emits carry end objects; _fire resolves them
            # against the new layout and drops just-detached streams)
            emits = tuple(e for emit in emits for e in emit)
            # compile the (possibly) new padded shape and discard the
            # counters accumulated during the rebuild BEFORE releasing
            # the lock: a monitor thread sampling in between would fold
            # the whole restructure interval as one nominal period (a
            # rate spike the control loop could act on) and pay the
            # first-call compile on its sampling tick
            self._warm_compile()
            self._discard_counters_locked()
        self._fire(emits)

    def _dispatch_locked(self) -> tuple:
        if self.n_streams == 0:        # empty fleet: nothing to estimate
            self._col = 0
            return self._harvest_locked()
        cols = self._col
        tc_rows, blk_rows = self._tc[:cols], self._blocked[:cols]
        # swap staging: the dispatch reads this tile while the collector
        # keeps writing into the other buffer
        self._tc, self._tc_shadow = self._tc_shadow, self._tc
        self._blocked, self._blk_shadow = self._blk_shadow, self._blocked
        self._col = 0
        self._blocked[:] = True
        emit = self._harvest_locked()   # previous dispatch, now complete
        self._refresh_slo_locked()      # once per chunk, off the tick

        # per-queue implied service times (period / items) -> fleet cv^2,
        # one fused masked-moment evaluation for the whole tile: the head
        # streams' columns, gathered into (q, cols) rows in per-queue
        # stream order (a C-ordered copy, the layout the moments reduce)
        q = len(self.queues)
        head_rows = self._row_of_stream[:q]
        head_tc, head_blk = tc_rows.T[head_rows], blk_rows.T[head_rows]
        valid = (head_tc > 0) & ~head_blk
        self.classifier.update_batch(
            np.where(valid, self.period_s / np.maximum(head_tc, 1e-30),
                     0.0), where=valid)

        # the estimator reads the (cols, S) staging as its time-major
        # (S, cols) view: uploaded as it is, no transpose-copy
        tc, blocked = self._upload(tc_rows, blk_rows)
        self._state, _ = run_monitor_fleet(
            self.cfg, tc.T, blocked.T, state=self._state,
            chunk_t=self.chunk_t, impl=self.impl, mode="state",
            donate=True, pad_q=False, device=self.device)
        self._queue_readback()
        self.dispatches += 1
        self._pending = True
        return emit

    def _upload(self, tc: np.ndarray, blocked: np.ndarray):
        """(cols, S) host staging -> device tensors of the same layout:
        f32 into the pinned buffer, then a non-blocking copy (a plain
        tensor on the CPU)."""
        n = tc.size
        shape = tc.shape
        pin_tc = self._pin_tc[:n].view(shape)
        pin_blk = self._pin_blk[:n].view(shape)
        pin_tc.copy_(torch.from_numpy(tc))
        pin_blk.copy_(torch.from_numpy(blocked))
        if self.device.type != "cuda":
            return pin_tc, pin_blk
        return (pin_tc.to(self.device, non_blocking=True),
                pin_blk.to(self.device, non_blocking=True))

    def _queue_readback(self) -> None:
        """Queue the harvest's device->host copies behind the dispatch
        and record the event the harvest waits on."""
        st = self._state
        for name, buf in self._pin_out.items():
            buf.copy_(getattr(st, name), non_blocking=True)
        if self.device.type == "cuda":
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(self.device))

    def _harvest_locked(self) -> tuple:
        """Read back the last dispatch's epochs/estimates (blocks only if
        the asynchronous dispatch has not finished yet)."""
        if not self._pending:
            return ()
        self._pending = False
        if self._event is not None:
            self._event.synchronize()
            self._event = None
        out = {k: v.numpy() for k, v in self._pin_out.items()}
        epochs = out["epoch"].astype(np.int64)
        ests = out["last_qbar"].copy()
        newly = np.nonzero(epochs > self._epochs)[0]    # staging rows
        self._epochs = epochs
        # refresh the numpy gate mirrors (array replacement, not
        # mutation — readers holding the old arrays stay consistent)
        self._qbar_np = ests
        self._count_np = out["count"].copy()
        self._mean_np = out["mean"].copy()
        self._nblk_np = out["n_blocked"].astype(np.int64)
        self._ntot_np = out["n_total"].astype(np.int64)
        streams = self._stream_of_row[newly]
        # emits carry the END OBJECTS, not indices: indices are only
        # resolved against the live layout at fire time (_fire), so an
        # attach/detach landing between harvest and fire can never make
        # a consumer resolve a stale index against the new fleet
        return tuple((self._end_stats[si], float(ests[r]) / self.period_s)
                     for si, r in zip(streams, newly))

    def _refresh_slo_locked(self) -> None:
        """Fold the latest latency-histogram / error-counter window into
        the SLO mirrors (``self._lock`` held).  Under the arena lock the
        harvest gathers only the (S,) scalar columns (error and
        observation counts); the per-slot count is the change detector —
        full (B,) histogram rows are gathered ONLY for slots whose count
        moved since the previous window, so a mostly-idle 1e5-end fleet
        pays for its hot ends, not its span.  Runs once per fused
        dispatch (every ``chunk_t`` ticks), never on the per-tick
        collector path, with no per-end python loop.

        Windows with zero observations keep their last known percentiles
        (display stability) but publish a ZERO histogram window, so
        ``over_fraction`` reports NaN = "no evidence" and the control
        loop's burn EMA decays toward zero — an idle or fully-shed queue
        must not pin a stale-hot burn rate forever."""
        if self.n_streams == 0:
            return
        arena = self._arena
        with arena.lock:
            if arena.layout_version != self._layout_version:
                self._rebind_slots_locked()
            idx = self._slots
            cnts = np.array(arena.lat_count[idx], np.int64)
            errs = np.array(arena.err_count[idx], np.int64)
            # lat_count is written after the row (see record_latency),
            # so every entry a count bump announces is already in the
            # row this same gather sees
            changed = np.flatnonzero(cnts != self._cnt_prev)
            rows_at = (idx.start + changed if isinstance(idx, slice)
                       else idx[changed])
            rows = np.array(arena.lat_hist[rows_at], np.int64)
        now = time.monotonic()
        dt = 0.0 if self._slo_t is None else max(now - self._slo_t, 0.0)
        self._slo_t = now
        # error deltas, sparse like the histogram window: one (S,)
        # compare finds the rows that moved, then only those pay the
        # delta/total/rate arithmetic — the dense (S,) maximum+add+
        # divide chain was half the idle fold's cost at S=2e5.  A
        # recycled slot re-zeroes its counter between gathers: clip the
        # delta at zero rather than folding a huge negative wrap.
        err_moved = np.flatnonzero(errs != self._err_prev)
        d_err = (np.maximum(errs[err_moved] - self._err_prev[err_moved],
                            0) if err_moved.size
                 else np.empty((0,), np.int64))
        self._err_prev = errs
        self._cnt_prev = cnts
        # mirrors publish by array replacement so readers holding the
        # old arrays stay internally consistent (same contract as
        # harvest) — except _pctl_np, which mutates in place and is
        # only ever indexed under the lock
        if changed.size:
            d_rows = np.maximum(rows - self._hist_prev[changed], 0)
            self._hist_prev[changed] = rows
            row_tot = d_rows.sum(axis=1)
            pos = row_tot > 0
            if pos.any():
                # the percentile mirror mutates IN PLACE (a full (s, K)
                # copy per harvest is real money at s=2e5): every reader
                # — latency_percentiles, obs_snapshot, the restructure
                # carry — indexes it under ``self._lock``, which this
                # fold holds, so no torn row is ever observable
                self._pctl_np[changed[pos]] = hist_quantiles(d_rows[pos],
                                                             self._QS)
            lat_count = self._lat_count_np.copy()
            lat_count[changed] += row_tot
            self._lat_count_np = lat_count
            # publish the window sparsely — the hot set and its rows —
            # so the fold's cost scales with the slots that MOVED, never
            # with the span (a dense (s, B) publish would re-zero the
            # whole plane every window)
            self._win_idx, self._win_hist = changed, d_rows
        else:
            # untouched fleet: an empty support set IS the zero window,
            # and the idle fold stays O(S) scalars, no (S, B) traffic
            self._win_idx = np.empty((0,), np.intp)
            self._win_hist = np.empty((0, LAT_BUCKETS), np.int64)
        if err_moved.size:
            err_total = self._err_total_np.copy()
            err_total[err_moved] += d_err
            self._err_total_np = err_total
        rate = np.zeros((errs.shape[0],))
        if dt > 0 and err_moved.size:
            rate[err_moved] = d_err / dt
        self._err_rate_np = rate

    def _fire(self, emit: tuple) -> None:
        """Run user callbacks outside the lock: a slow or re-entrant
        callback must not stall or deadlock the sampling thread.  The
        harvested (end, rate) pairs are resolved to public stream
        indices against the CURRENT layout here — ends that left the
        fleet since the harvest are dropped, retained ones report their
        post-restructure indices."""
        if not emit:
            return
        with self._lock:
            idx_of = {id(e): i for i, e in enumerate(self._end_stats)}
        resolved = [(idx_of[id(e)], r) for e, r in emit
                    if id(e) in idx_of]
        if not resolved:
            return
        if self.on_fleet is not None:
            idx = np.array([si for si, _ in resolved], np.int64)
            rates = np.array([r for _, r in resolved])
            self.on_fleet(idx, rates)
        if self.on_converged is not None:
            for si, rate in resolved:
                self.on_converged(si, rate)

    # -- readouts ---------------------------------------------------------
    def state_snapshot(self) -> FleetMonitorState:
        """Materialized numpy copy of the fleet state in public stream
        order (heads 0..Q-1, then tails), taken under the collector
        lock.  The live device state must never escape: the next
        dispatch updates its tensors in place."""
        with self._lock:
            rows = self._row_of_stream
            return FleetMonitorState(*(leaf.cpu().numpy()[rows]
                                       for leaf in self._state))

    def _public_q(self, n_streams: int) -> int:
        """Queue count implied by a readout's own stream count — used
        instead of the live ``len(self.queues)`` so a readout captured
        just before a concurrent attach/detach still slices itself
        consistently."""
        return n_streams // 2 if self.ends == "both" else n_streams

    def epochs(self) -> np.ndarray:
        """(S,) convergence epochs in public stream order."""
        with self._lock:
            return self._epochs[self._row_of_stream]

    def _gated_rates(self) -> np.ndarray:
        """Readiness-gated items/s for every stream (see
        ``fleet_rate_readout``): converged estimate, else the running
        q-bar once ``min_q_samples`` folds accumulated, else 0."""
        return fleet_rate_readout(self.cfg, self.state_snapshot(),
                                  self.period_s)

    def gated_rates(self) -> np.ndarray:
        """(S,) gated items/s in public stream order — heads 0..Q-1,
        then tails when ``ends='both'``.

        This is the control loop's sense step, so it is deliberately
        lean: it reads the numpy gate mirrors refreshed at harvest time
        (one fused dispatch behind, which is when estimates move at all)
        and applies ``fleet_rate_readout``'s formula — no device
        traffic, no (S, window) ring materialization.  One call serves
        both rate legs."""
        with self._lock:
            epoch, count = self._epochs, self._count_np
            mean, last = self._mean_np, self._qbar_np
            rows = self._row_of_stream    # captured WITH the mirrors: a
            # concurrent attach/detach replaces both together, so a
            # readout never indexes old arrays with a new permutation
        rates = gated_rate_arrays(self.cfg, epoch, count, mean, last,
                                  self.period_s)
        return rates[rows]

    def blocked_counts(self) -> tuple[np.ndarray, np.ndarray]:
        """(S,) cumulative ``(n_blocked, n_total)`` period counts in
        public stream order, from the harvest-time mirrors.  The control
        loop differences consecutive readings to detect *saturation*: a
        tail leg blocking nearly every recent period means the producer
        cannot push — demand exceeds capacity and is unobservable, the
        paper's Pr[WRITE] -> 0 regime."""
        with self._lock:
            nb, nt = self._nblk_np, self._ntot_np
            rows = self._row_of_stream
        return nb[rows], nt[rows]

    def recent_rates(self, which: str = "both") -> np.ndarray:
        """Mean of each stream's last ``window`` valid q-folds as
        items/s, public stream order — the freshest level signal the
        state carries, deliberately NOT readiness-gated.  The control
        loop compares this against ``gated_rates`` to detect *stale*
        demand: an arrival estimate that converged and then went quiet
        never re-converges (the epoch freezes at the old high level
        while near-zero samples fold into the window), so without this
        signal escalated provision would ratchet forever.

        ``which`` selects ``"both"`` ((S,), all streams), ``"head"`` or
        ``"tail"`` ((Q,), that half only — the control loop reads just
        the tails, and at fleet scale copying the other half of the
        (S, window) ring per tick would be pure waste).  Computed on
        demand from the live state, not a harvest-time mirror: the copy
        is fleet-size proportional and only control loops read it."""
        with self._lock:
            rows = self._row_of_stream
            q = self._public_q(rows.shape[0])
            if which == "head":
                rows = rows[:q]
            elif which == "tail":
                rows = rows[q:]
            elif which != "both":
                raise ValueError(f"bad which {which!r}")
            # read back under the lock: the next dispatch updates the
            # state in place (see state_snapshot); fancy-indexing yields
            # public order directly
            win = self._state.win.cpu().numpy()[rows]
            fill = self._state.s_fill.cpu().numpy()[rows]
        recent = win.sum(axis=1) \
            / np.maximum(np.minimum(fill, win.shape[1]), 1)
        scale = 1.0 / self.period_s if self.period_s > 0 else 0.0
        return recent * scale

    def service_rates(self) -> np.ndarray:
        """(Q,) consumer non-blocking service rates, items/s (gated)."""
        rates = self._gated_rates()
        return rates[:self._public_q(rates.shape[0])]

    def arrival_rates(self) -> np.ndarray:
        """(Q,) producer arrival rates, items/s (gated); requires
        ``ends='both'``."""
        if self.ends != "both":
            raise ValueError("arrival rates need ends='both'")
        rates = self._gated_rates()
        return rates[self._public_q(rates.shape[0]):]

    def rates_items_per_s(self) -> np.ndarray:
        """Back-compat alias for the head-end readout."""
        return self.service_rates()

    def observed_blocking_fraction(self) -> np.ndarray:
        state = self.state_snapshot()
        q = self._public_q(state.n_total.shape[0])
        n_total = np.maximum(state.n_total[:q], 1)
        return state.n_blocked[:q] / n_total

    def cv2s(self) -> np.ndarray:
        """(Q,) squared coefficient of variation of each queue's service
        process — feeds ``BufferAutotuner.recommend_fleet``."""
        cv2 = np.asarray(self.classifier.cv2)
        # queues without enough samples fall back to M/M (cv2 = 1)
        return np.where(self.classifier.counts >= 16, cv2, 1.0)

    # -- SLO-plane readouts (latency histograms / errors) -----------------
    def _rows_for(self, which: str) -> np.ndarray:
        """Public->internal row map for a stream subset, captured by the
        caller under ``self._lock`` together with the mirrors it
        indexes."""
        rows = self._row_of_stream
        q = self._public_q(rows.shape[0])
        if which == "head":
            return rows[:q]
        if which == "tail":
            return rows[q:]
        if which != "both":
            raise ValueError(f"bad which {which!r}")
        return rows

    def latency_percentiles(self, which: str = "head") -> np.ndarray:
        """(N, 4) seconds — p50/p90/p99/p999 (``_QS``) of the most
        recent non-empty chunk window, public stream order; NaN until a
        stream has recorded any latency.  Interpolated within the
        log-spaced arena buckets (see ``arena.hist_quantiles``)."""
        with self._lock:
            return self._pctl_np[self._rows_for(which)]

    def latency_counts(self, which: str = "head") -> np.ndarray:
        """(N,) cumulative latency observations since monitoring began
        (window totals accumulated at harvest), public stream order."""
        with self._lock:
            return self._lat_count_np[self._rows_for(which)]

    def error_totals(self, which: str = "head") -> np.ndarray:
        """(N,) cumulative error counts, public stream order."""
        with self._lock:
            return self._err_total_np[self._rows_for(which)]

    def error_rates(self, which: str = "head") -> np.ndarray:
        """(N,) errors/s over the last chunk window, public order."""
        with self._lock:
            return self._err_rate_np[self._rows_for(which)]

    def over_fraction(self, thresholds,
                      which: str = "head") -> np.ndarray:
        """(N,) fraction of the last chunk window's observations whose
        latency exceeded ``thresholds`` (seconds, broadcastable to N;
        NaN threshold = no SLO).  NaN where the window holds no
        observations — "no evidence", which the control loop's burn EMA
        treats as zero budget consumption (nothing served = nothing
        over SLO).  This is the SLO leg's sense input."""
        with self._lock:
            rows = np.asarray(self._rows_for(which))
            win_idx, win_hist = self._win_idx, self._win_hist
            n_rows = self._epochs.shape[0]
        out = np.full(rows.shape[0], np.nan)
        if win_idx.size:
            # scatter the sparse window support onto the requested rows;
            # rows outside the support had no observations -> NaN
            pos = np.full(n_rows, -1, np.intp)
            pos[win_idx] = np.arange(win_idx.size, dtype=np.intp)
            hit = pos[rows] >= 0
            if hit.any():
                th = np.broadcast_to(
                    np.asarray(thresholds, float), out.shape)
                out[hit] = hist_over_fraction(win_hist[pos[rows[hit]]],
                                              th[hit])
        return out

    def obs_snapshot(self) -> dict:
        """One consistent observability snapshot for the exporter: every
        SLO mirror plus the rate mirrors, captured under a single lock
        acquisition so a scrape never mixes two harvest generations.
        Arrays are the internal mirrors permuted to public stream order
        (mirrors are replaced, never mutated — except the percentile
        mirror, which mutates in place and is therefore permuted-copied
        here UNDER the lock; the returned arrays are stable after
        return)."""
        with self._lock:
            rows = self._row_of_stream
            q = self._public_q(rows.shape[0])
            epoch, count = self._epochs, self._count_np
            mean, last = self._mean_np, self._qbar_np
            pctl = self._pctl_np[rows]
            err_rate, err_total = self._err_rate_np, self._err_total_np
            lat_count = self._lat_count_np
            nblk, ntot = self._nblk_np, self._ntot_np
            dispatches = self.dispatches
        rates = gated_rate_arrays(self.cfg, epoch, count, mean, last,
                                  self.period_s)
        return {
            "q": q,
            "rates": rates[rows],
            "epochs": epoch[rows],
            "percentiles": pctl,
            "quantile_qs": np.array(self._QS),
            "error_rates": err_rate[rows],
            "error_totals": err_total[rows],
            "latency_counts": lat_count[rows],
            "n_blocked": nblk[rows],
            "n_total": ntot[rows],
            "dispatches": dispatches,
        }
