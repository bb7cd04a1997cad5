"""Shared counter arena: contiguous (S,) instrumentation arrays.

The paper instruments each queue end with a non-blocking transaction
counter ``tc`` and a ``blocked`` flag (§III).  At fleet scale the
monitor cannot afford to touch S python objects per sampling tick, so
every monitored end is a *slot view* into one process-wide
``CounterArena``: contiguous per-slot columns (``tc``, ``blocked``,
``bytes_count``, ``err_count``, and the (S, B) ``lat_hist`` latency
histogram — see the bucket constants below) indexed by slot.  Producers
and consumers increment single cells (single-writer per cell, as in the
paper); the fleet collector samples every monitored end in a handful of
vectorized ops — one gather, one fused scale, one zero-fill — with no
per-end python iteration (the 10^5-queue step).

The paper's non-locking copy-and-zero contract carries over unchanged
to arena cells: a monitor clear racing a cell increment can drop either
side (a numpy ``arr[i] += 1`` is a read-modify-write across several
bytecodes), which Algorithm 1 is built to tolerate — blocked periods
are discarded and q-bar folds smooth single-period jitter.  The arena
lock guards only *structural* transitions (slot alloc/retire, geometric
growth) plus the collector's copy-and-zero window, so an arena grow can
never lose a whole sampling tick; it is never taken on the push/pop hot
path.

The SLO observability columns ride the same contract with one twist:
``lat_hist`` (cumulative (S, B) log-bucket latency histogram, fed by
``record_latency``), ``err_count`` and the (S,) ``lat_count`` change
detector are **cumulative** — the collector never zeroes them; windows
are formed downstream by differencing against mirrors, so a torn
gather costs at worst a one-window delay instead of lost samples.
``record_latency`` bumps ``lat_count`` strictly AFTER folding the
histogram row (same thread, program order), so a harvester that sees a
moved count is guaranteed the entries the bump announces are already
in the row it gathers — that is what lets the fleet harvest gather
only (S,) scalars per window and pay for full (B,) rows ONLY on slots
whose count moved (see ``fleet._refresh_slo_locked``).

Slots are recycled: an ``EndStats`` returns its slot when explicitly
``release()``-d (``InstrumentedQueue.close()``) or when garbage
collected, so churning fleets reuse low slots instead of growing the
arena without bound.  A released end must no longer be written — its
slot may already back a new queue.

Long-lived churning fleets fragment: retiring the middle of a
co-allocated run leaves holes, and every service whose slots are no
longer one contiguous ascending run falls off the slice fast path onto
the gather path.  The arena therefore *defragments on retire*: when the
live-slot span's hole fraction passes ``defrag_threshold`` the live
ends are compacted (order-preserving) into the lowest slots and every
view is rebound, growth-style — fresh arrays are installed so an
increment racing the move lands on the abandoned arrays and is dropped,
never misattributed (the same benign single-period race as ``_grow``).
``layout_version`` is bumped on every slot move; monitoring services
compare it each tick and re-derive their slot index (and slice-ness)
when it changes.
"""

from __future__ import annotations

import collections
import threading
import weakref
from typing import Optional

import numpy as np

__all__ = ["CounterArena", "EndStats", "default_arena",
           "LAT_BUCKETS", "LAT_EDGES", "LAT_BOUNDS", "lat_bucket",
           "hist_quantiles", "hist_over_fraction"]

# -- fixed log-spaced latency buckets (the SLO observability plane) ----------
#
# Every slot carries one (LAT_BUCKETS,) row of a contiguous (S, B) int
# histogram column: bucket 0 is [0, LAT_EDGES[0]), bucket i is
# [LAT_EDGES[i-1], LAT_EDGES[i]), and the last bucket is the +inf
# overflow.  The edges are fixed at import time (log-spaced, 100 us to
# 100 s, ~1.59x per bucket) so every recorder and every reader in the
# process agrees on the layout and the fleet harvest is pure array math
# — no per-slot edge metadata, no per-end python state.
LAT_BUCKETS = 32
LAT_EDGES = np.logspace(-4.0, 2.0, LAT_BUCKETS - 1)
# interpolation bounds: LAT_BOUNDS[b] .. LAT_BOUNDS[b+1] brackets bucket
# b; the open-ended overflow bucket gets one more log step so
# within-bucket interpolation stays finite there too
LAT_BOUNDS = np.concatenate((
    [0.0], LAT_EDGES, [LAT_EDGES[-1] * (LAT_EDGES[-1] / LAT_EDGES[-2])]))

# names of the per-slot arena columns; (S,) unless noted.  _grow /
# _defragment_locked / slot recycling iterate this tuple so a new
# column automatically inherits the benign-race growth contract.
_COLUMNS = ("tc", "blocked", "bytes_count", "err_count", "lat_count",
            "lat_hist")


def lat_bucket(seconds: float) -> int:
    """Bucket index for one latency sample (scalar or array)."""
    return np.searchsorted(LAT_EDGES, seconds, side="right")


def hist_quantiles(hist: np.ndarray, qs=(0.5, 0.9, 0.99, 0.999)
                   ) -> np.ndarray:
    """Per-row quantiles from (R, B) bucket counts via within-bucket
    linear interpolation against ``LAT_BOUNDS``.  Returns (R, len(qs))
    seconds; rows with zero observations come back NaN.  Pure
    vectorized numpy — the fleet harvest calls this once per dispatch
    for every monitored stream at once."""
    hist = np.asarray(hist)
    if hist.ndim == 1:
        hist = hist[None, :]
    r, b = hist.shape
    cum = np.cumsum(hist, axis=1, dtype=np.float64)
    total = cum[:, -1]
    lo = LAT_BOUNDS[:-1]
    width = LAT_BOUNDS[1:] - LAT_BOUNDS[:-1]
    has = total > 0
    if not has.any():
        return np.full((r, len(qs)), np.nan)
    # all quantiles at once: the (R, K, B) comparison is tiny (B = 32,
    # K a handful) and one broadcast beats K python-level passes — this
    # runs on every harvest's fresh rows
    target = np.asarray(qs, np.float64)[None, :] * total[:, None]
    # first bucket whose cumulative count reaches each target
    bi = np.minimum((cum[:, None, :] < target[:, :, None]).sum(axis=2),
                    b - 1)
    prev = np.where(bi > 0,
                    np.take_along_axis(cum, np.maximum(bi - 1, 0), 1),
                    0.0)
    cnt = np.take_along_axis(hist, bi, 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = np.clip((target - prev) / np.maximum(cnt, 1e-300),
                       0.0, 1.0)
    return np.where(has[:, None], lo[bi] + frac * width[bi], np.nan)


def hist_over_fraction(hist: np.ndarray, thresholds) -> np.ndarray:
    """Per-row fraction of observations strictly above ``thresholds``
    (seconds; scalar or (R,), NaN = no threshold), with the threshold's
    own bucket apportioned by within-bucket linear interpolation.
    Rows with zero observations (or a NaN threshold) come back NaN —
    the burn-rate leg treats those as "no evidence", not "no burn"."""
    hist = np.asarray(hist)
    if hist.ndim == 1:
        hist = hist[None, :]
    r, b = hist.shape
    th = np.broadcast_to(np.asarray(thresholds, np.float64), (r,))
    total = hist.sum(axis=1, dtype=np.float64)
    safe_th = np.where(np.isfinite(th), th, 0.0)
    bi = np.minimum(np.searchsorted(LAT_EDGES, safe_th, side="right"),
                    b - 1)
    cum = np.cumsum(hist, axis=1, dtype=np.float64)
    below = np.where(bi > 0,
                     np.take_along_axis(
                         cum, np.maximum(bi - 1, 0)[:, None], 1)[:, 0],
                     0.0)
    cnt = np.take_along_axis(hist, bi[:, None], 1)[:, 0]
    lo = LAT_BOUNDS[:-1][bi]
    width = (LAT_BOUNDS[1:] - LAT_BOUNDS[:-1])[bi]
    with np.errstate(divide="ignore", invalid="ignore"):
        infrac = np.clip((safe_th - lo) / np.maximum(width, 1e-300),
                         0.0, 1.0)
        over = total - below - infrac * cnt
        frac = np.clip(over / total, 0.0, 1.0)
    return np.where((total > 0) & np.isfinite(th), frac, np.nan)


class EndStats:
    """One queue end's instrumentation, as a slot view into an arena.

    Keeps the object API (``end.tc += 1``, ``end.blocked = True``)
    while the storage is an arena cell; the raw array references
    (``_tc``/``_blk``/``_byt``) are rebound by the arena on growth and
    exist so hot paths can cache ``end._tc[end._slot]`` access without
    going through the properties.
    """

    __slots__ = ("_arena", "_slot", "_tc", "_blk", "_byt", "_err",
                 "_hist", "_cnt", "_finalizer", "_pins", "__weakref__")

    def __init__(self, arena: Optional["CounterArena"] = None):
        # monitors that currently gather this slot; weak so a dead
        # service un-pins automatically
        self._pins: weakref.WeakSet = weakref.WeakSet()
        (arena if arena is not None else default_arena())._attach(self)

    def _bind(self, arena: "CounterArena", slot: int) -> None:
        """(Re)point the view at the arena's current arrays — called at
        attach time and again on arena growth or defragmentation.

        Write order is a contract with the lock-free hot paths: ``_slot``
        first, array refs after.  Readers load the array ref before the
        slot, so a read pair torn by a concurrent rebind always indexes
        the *abandoned* array (a dropped increment — the paper's benign
        single-period race) and can never land a count in another live
        end's cell of the fresh array."""
        self._arena = arena
        self._slot = slot
        self._tc = arena.tc
        self._blk = arena.blocked
        self._byt = arena.bytes_count
        self._err = arena.err_count
        self._hist = arena.lat_hist
        self._cnt = arena.lat_count

    @property
    def arena(self) -> "CounterArena":
        return self._arena

    @property
    def slot(self) -> int:
        return self._slot

    # -- the paper's counter API, backed by arena cells -------------------
    @property
    def tc(self):
        return self._tc[self._slot]

    @tc.setter
    def tc(self, v) -> None:
        # benign-race: copy-and-zero — lock-free hot-path write, torn
        # reads cost one monitoring period (growth-rebind on regrow)
        self._tc[self._slot] = v

    @property
    def blocked(self):
        return self._blk[self._slot]

    @blocked.setter
    def blocked(self, v) -> None:
        # benign-race: copy-and-zero — see the ``tc`` setter
        self._blk[self._slot] = v

    @property
    def bytes_count(self):
        return self._byt[self._slot]

    @bytes_count.setter
    def bytes_count(self, v) -> None:
        # benign-race: copy-and-zero — see the ``tc`` setter
        self._byt[self._slot] = v

    @property
    def err_count(self):
        return self._err[self._slot]

    @err_count.setter
    def err_count(self, v) -> None:
        # benign-race: cumulative-window — see ``record_error``
        self._err[self._slot] = v

    def record_latency(self, seconds, n: int = 1) -> None:
        """Fold latency observations into this slot's histogram row —
        the hot-path recording primitive (one searchsorted + one cell
        increment for a scalar, one ``bincount`` fold for a batch),
        lock-free.  Cumulative: never zeroed by the collector tick,
        only by slot recycling.  Array ref before slot, like every
        hot-path write — a record torn by a concurrent grow/defrag
        lands in the abandoned array (a dropped sample, the benign
        race), never in another live slot's row.

        The scalar ``lat_count`` cell is bumped AFTER the row: a
        harvest that observes the new count therefore observes the new
        entries too (same-thread write order), so the count is a sound
        change detector — a record torn across a rebind can at worst
        delay one window's entries to the next count bump, the same
        single-period tolerance as everything else here."""
        hist = self._hist
        cnt = self._cnt
        slot = self._slot
        b = np.searchsorted(LAT_EDGES, seconds, side="right")
        if np.ndim(b):
            # batch fold: fancy-index += drops duplicate buckets, so
            # aggregate first; one row-add keeps the torn-write story
            # identical to the scalar path (one array touched once)
            # benign-race: cumulative-window — monotone row, harvested
            # by delta; a racing rebind drops the fold (growth-rebind)
            hist[slot] += np.bincount(b, minlength=LAT_BUCKETS) * n
            # benign-race: cumulative-window — count bumped after row
            cnt[slot] += b.size * n
        else:
            # benign-race: cumulative-window — see the batch branch
            hist[slot, b] += n
            # benign-race: cumulative-window — count bumped after row
            cnt[slot] += n

    def record_error(self, n: int = 1) -> None:
        """Count ``n`` errors (deadline misses, sheds, failures) against
        this slot — cumulative, same contract as ``record_latency``."""
        err = self._err
        # benign-race: cumulative-window — monotone, harvested by delta
        err[self._slot] += n

    def latency_histogram(self) -> np.ndarray:
        """Copy of this slot's cumulative (LAT_BUCKETS,) bucket row."""
        hist = self._hist
        return hist[self._slot].copy()

    def sample_and_reset(self) -> tuple[float, bool, int]:
        """Monitor-side copy-and-zero of one end (non-locking) — the
        scalar form; fleet collection goes through the arena arrays."""
        tc_a, blk_a, byt_a = self._tc, self._blk, self._byt
        s = self._slot       # array refs before slot: see _bind
        tc, blk, nb = tc_a[s], blk_a[s], byt_a[s]
        # benign-race: copy-and-zero — the paper's single-period race:
        # increments landing between the copy and the zero are dropped
        tc_a[s] = 0.0
        # benign-race: copy-and-zero — see above
        blk_a[s] = False
        # benign-race: copy-and-zero — see above
        byt_a[s] = 0
        return float(tc), bool(blk), int(nb)

    def release(self) -> None:
        """Return the slot to the arena (idempotent).  The end must not
        be written afterwards: its slot may back a new end.  Raises
        while a live monitor still gathers the slot — recycling it then
        would silently corrupt the next owner's counters."""
        if self._pins:
            raise ValueError(
                "cannot release a queue end while a live "
                "FleetMonitorService monitors it")
        self._finalizer()
        # explicit release is a structural op: recycle now and compact
        # if the retire pushed fragmentation over the threshold (the
        # GC-finalizer path defers both to the next structural op)
        self._arena._after_release()


class CounterArena:
    """Contiguous (capacity,) counter arrays with slot alloc/retire and
    geometric growth.  ``tc``/``blocked``/``bytes_count`` are the live
    arrays — replaced wholesale on growth, with every attached
    ``EndStats`` view rebound under the lock."""

    def __init__(self, capacity: int = 256, *,
                 defrag_threshold: float = 0.5):
        capacity = max(int(capacity), 1)
        self.lock = threading.Lock()
        self.tc = np.zeros(capacity)
        self.blocked = np.zeros(capacity, bool)
        self.bytes_count = np.zeros(capacity, np.int64)
        # SLO plane: per-slot cumulative error counters and fixed-bucket
        # latency histogram rows — one contiguous (S, B) column so the
        # fleet harvest is a single row gather (see module header)
        self.err_count = np.zeros(capacity, np.int64)
        self.lat_hist = np.zeros((capacity, LAT_BUCKETS), np.int64)
        # per-slot cumulative observation count, written AFTER the
        # histogram row by ``record_latency`` — the fleet harvest's
        # change detector: an (S,) count gather decides which (B,) rows
        # actually need the expensive (S, B) gather this window
        self.lat_count = np.zeros(capacity, np.int64)
        # compact when holes exceed this fraction of the live span
        # (<= 0 disables; 1.0 compacts only a fully-dead span)
        self.defrag_threshold = float(defrag_threshold)
        # bumped whenever live slots MOVE (defragmentation) — services
        # re-derive their cached slot index when this changes.  Growth
        # does not bump it: slots keep their numbers across _grow.
        self.layout_version = 0
        # low slots first, so co-allocated fleets land contiguously
        self._free = list(range(capacity - 1, -1, -1))
        self._ends: dict[int, weakref.ref] = {}
        # slots released from GC finalizers land here lock-free and are
        # recycled by the next structural op (see _release_slot)
        self._pending_free: collections.deque = collections.deque()

    @property
    def capacity(self) -> int:
        return self.tc.shape[0]

    def snapshot_slots(self, ends) -> tuple[np.ndarray, int]:
        """One consistent ``(slots, layout_version)`` read for a set of
        ends.  Slot numbers and the layout version must be read under
        one lock hold: a concurrent defragmentation moving slots between
        the two reads would hand the caller old cell indices already
        paired with the new version, so its staleness check could never
        fire.  Used by ``FleetMonitorService`` at construction and on
        every multi-tenant attach/detach restructure."""
        with self.lock:
            return (np.array([e.slot for e in ends], np.intp),
                    self.layout_version)

    def __len__(self) -> int:
        """Live (attached) slots."""
        with self.lock:
            self._drain_pending_locked()
            return len(self._ends)

    def alloc(self) -> EndStats:
        return EndStats(self)

    def reserve_span(self, n: int) -> None:
        """Guarantee the next ``n`` allocations land on one contiguous
        *ascending* slot run — the co-allocation contract behind
        per-class engine lanes: a block of lanes allocated after a
        reservation is a slice for every fleet collector that gathers
        it, never the gather path.  Cheap when the free list's tail is
        already a run (the common fresh-arena case); otherwise compacts
        (one ``_defragment_locked``), and as a last resort grows — a
        grow appends the whole new top half as one ascending run."""
        n = int(n)
        if n <= 0:
            return
        with self.lock:
            self._drain_pending_locked()
            if self._span_ready_locked(n):
                return
            self._defragment_locked()
            if self._span_ready_locked(n):
                return
            while self.capacity < n:
                self._grow()
            self._grow()

    def _span_ready_locked(self, n: int) -> bool:
        """True when the next ``n`` pops off ``_free`` (taken from the
        end) form one contiguous ascending slot run."""
        free = self._free
        if len(free) < n:
            return False
        lo = free[-1]
        return all(free[-1 - i] == lo + i for i in range(n))

    def _attach(self, end: EndStats) -> None:
        with self.lock:
            self._drain_pending_locked()
            # GC-path retirements surface here: compact before
            # allocating so new fleets co-allocate low and contiguous
            self._maybe_defragment_locked()
            if not self._free:
                self._grow()
            slot = self._free.pop()
            end._bind(self, slot)
            self._ends[slot] = weakref.ref(end)
            end._finalizer = weakref.finalize(end, self._release_slot, slot)

    def _release_slot(self, slot: int) -> None:
        """May run from a GC-triggered weakref finalizer on a thread
        that already holds the (non-reentrant) arena lock — e.g. the
        collector's gather allocates and trips a cyclic-GC pass — so it
        must not acquire the lock.  Recycling is deferred to the next
        structural op, which drains under the lock."""
        self._pending_free.append(slot)

    def _drain_pending_locked(self) -> None:
        pending = self._pending_free
        while True:
            try:
                slot = pending.popleft()
            except IndexError:
                return
            self.tc[slot] = 0.0
            self.blocked[slot] = False
            self.bytes_count[slot] = 0
            self.err_count[slot] = 0
            self.lat_hist[slot] = 0
            self.lat_count[slot] = 0
            self._ends.pop(slot, None)
            self._free.append(slot)

    def _grow(self) -> None:
        """Double the arrays (lock held).  Increments racing the copy on
        the old arrays can be dropped — the same benign single-period
        race as the monitor's copy-and-zero, and growth is rare."""
        old_cap = self.capacity
        new_cap = old_cap * 2
        for name in _COLUMNS:
            old = getattr(self, name)
            new = np.zeros((new_cap,) + old.shape[1:], old.dtype)
            new[:old_cap] = old
            setattr(self, name, new)
        self._free.extend(range(new_cap - 1, old_cap - 1, -1))
        for slot, ref in self._ends.items():
            live = ref()
            if live is not None:
                live._bind(self, slot)

    # -- defragmentation ---------------------------------------------------
    def _after_release(self) -> None:
        """Structural follow-up to an explicit ``release()``: drain the
        pending-free list and compact if the retire fragmented the live
        span past the threshold."""
        with self.lock:
            self._drain_pending_locked()
            self._maybe_defragment_locked()

    def fragmentation(self) -> float:
        """Hole fraction of the live-slot span: 0.0 when the live slots
        are exactly 0..n-1 (every co-allocated service sees a slice),
        approaching 1.0 as retirements hollow the span out."""
        with self.lock:
            self._drain_pending_locked()
            return self._fragmentation_locked()

    def _fragmentation_locked(self) -> float:
        if not self._ends:
            return 0.0
        span = max(self._ends) + 1
        return 1.0 - len(self._ends) / span

    def defragment(self) -> bool:
        """Compact live slots to 0..n-1 now (order-preserving); returns
        True if any slot moved.  Runs automatically on explicit release
        and on attach when ``fragmentation() >= defrag_threshold``."""
        with self.lock:
            self._drain_pending_locked()
            return self._defragment_locked()

    def _maybe_defragment_locked(self) -> None:
        if (self.defrag_threshold > 0.0
                and self._fragmentation_locked() >= self.defrag_threshold):
            self._defragment_locked()

    def _defragment_locked(self) -> bool:
        """Order-preserving compaction (lock held).  Installs fresh
        arrays like ``_grow`` so a cell increment racing the move lands
        on the abandoned arrays and is dropped — never misattributed to
        a slot's next owner.  Every live end is materialized as a STRONG
        reference up front: an end whose weakref already died (finalizer
        not yet fired) is unmovable — its finalizer will release its
        *recorded* slot number — so compaction backs off and retries
        after that finalizer lands; the strong refs pin everything else
        alive through the whole move, closing the die-mid-compaction
        window."""
        live = sorted(self._ends)
        ends = []
        for slot in live:
            end = self._ends[slot]()
            if end is None:
                return False
            ends.append(end)
        target = {s: t for t, s in enumerate(live)}
        if all(s == t for s, t in target.items()):
            return False
        cap = self.capacity
        arrays = {}
        for name in _COLUMNS:
            old = getattr(self, name)
            arrays[name] = (old, np.zeros((cap,) + old.shape[1:],
                                          old.dtype))
        for slot in live:
            t = target[slot]
            for old, new in arrays.values():
                new[t] = old[slot]
        for name, (_, new) in arrays.items():
            setattr(self, name, new)
        new_ends: dict[int, weakref.ref] = {}
        for slot, end in zip(live, ends):
            t = target[slot]
            end._finalizer.detach()
            end._finalizer = weakref.finalize(end, self._release_slot, t)
            end._bind(self, t)
            new_ends[t] = self._ends[slot]
        self._ends = new_ends
        self._free = [s for s in range(cap - 1, -1, -1)
                      if s not in new_ends]
        self.layout_version += 1
        return True


_DEFAULT: Optional[CounterArena] = None
_DEFAULT_LOCK = threading.Lock()


def default_arena() -> CounterArena:
    """The process-wide arena every ``InstrumentedQueue`` backs into
    unless given its own — one shared counter store means any mix of
    pipelines/engines can ride a single vectorized collector pass."""
    global _DEFAULT
    if _DEFAULT is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                _DEFAULT = CounterArena()
    return _DEFAULT
