"""Instrumented SPSC ring buffer — the paper's queue mechanism (§III).

The queue keeps exactly the state the paper prescribes and nothing more:
a non-blocking transaction counter ``tc`` and a ``blocked`` boolean at
each end (head = consumer/departures, tail = producer/arrivals).  The
counters live as slot views into a shared ``CounterArena`` (see
``streams.arena``), so the fleet monitor copies-and-zeros the whole
fleet in a few vectorized array ops instead of touching S python
objects.  The non-locking contract is unchanged: single-writer cell
increments race the monitor's clear benignly (a clear landing
mid-firing drops one sample either way), which the heuristic is built
to tolerate.

Hot-path notes: push/pop cache the end's raw array reference and slot
in locals (rebound by the arena on growth, never mid-call in a way that
loses more than the benign single-period race) and use bitmask indexing
when the capacity is a power of two.  Buffer/index updates on both ends
serialize against a live controller ``resize`` through the queue's
resize lock; the counter increments themselves stay lock-free.  Both
ends re-validate their index under that lock, so the queue is also safe
with *duplicated* producers/consumers — live replica scaling
(``Pipeline.scale_stage``) pops one queue from several workers.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Optional

from repro_torch.streams.arena import CounterArena, EndStats, default_arena

__all__ = ["InstrumentedQueue", "EndStats", "CounterArena", "default_arena"]

_EMPTY = object()   # private empty-queue marker: stored None round-trips


def _mask_for(capacity: int) -> int:
    """Bitmask for power-of-two capacities, else -1 (use modulo)."""
    return capacity - 1 if capacity & (capacity - 1) == 0 else -1


class InstrumentedQueue:
    """Bounded SPSC queue with head/tail instrumentation and live resize.

    Producer API: ``try_push`` / ``push`` (blocking with backoff).
    Consumer API: ``try_pop`` / ``pop``.
    Monitor API:  ``head``/``tail`` EndStats (arena slot views),
    ``resize``, ``close`` (retire the arena slots).
    """

    def __init__(self, capacity: int = 64, item_bytes: int = 0,
                 name: str = "q", arena: Optional[CounterArena] = None):
        self.name = name
        self.item_bytes = item_bytes
        self._buf: list[Any] = [None] * capacity
        self._cap = capacity
        self._mask = _mask_for(capacity)
        self._head = 0      # next pop index (monotonic)
        self._tail = 0      # next push index (monotonic)
        self.arena = arena if arena is not None else default_arena()
        self.head = EndStats(self.arena)   # departures (reads by consumer)
        self.tail = EndStats(self.arena)   # arrivals (writes by producer)
        self._resize_lock = threading.Lock()

    # ---------------- producer ----------------------------------------------
    def try_push(self, item) -> bool:
        end = self.tail
        # the resize lock serializes the index/buffer update against a
        # live controller resize rebasing _head/_tail (try_pop ditto)
        with self._resize_lock:
            tail = self._tail
            if tail - self._head >= self._cap:
                # benign-race: growth-rebind — torn vs _bind drops one flag
                end._blk[end._slot] = True
                return False
            mask = self._mask
            i = (tail & mask) if mask >= 0 else (tail % self._cap)
            self._buf[i] = item
            self._tail = tail + 1
        # array ref BEFORE slot: _bind writes the slot first, so any
        # torn read pair lands in the abandoned pre-defrag array (a
        # dropped sample — the benign race) and never in another live
        # end's cell of the fresh array
        tc_arr = end._tc
        byt_arr = end._byt
        slot = end._slot
        # benign-race: copy-and-zero — an increment racing the monitor's
        # sample costs at most one period; growth-rebind covers regrows
        tc_arr[slot] += 1.0
        nbytes = self.item_bytes
        if nbytes:
            # benign-race: copy-and-zero — same one-period tolerance
            byt_arr[slot] += nbytes
        return True

    def push(self, item, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        backoff = 1e-6
        while not self.try_push(item):
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(backoff)
            backoff = min(backoff * 2, 1e-3)
        return True

    # ---------------- consumer ----------------------------------------------
    def try_pop(self, default=None):
        """Pop the next item, or ``default`` when the queue is empty.
        Pass a private sentinel as ``default`` to distinguish a stored
        ``None`` payload from emptiness (``pop`` does exactly that)."""
        end = self.head
        if self._head >= self._tail:
            # benign-race: growth-rebind — torn vs _bind drops one flag
            end._blk[end._slot] = True
            return default
        with self._resize_lock:
            head = self._head
            if head >= self._tail:
                # re-check under the lock: with a duplicated consumer
                # stage (live replica scaling) a sibling may have taken
                # the last item between the fast-path check and here —
                # popping anyway would hand out an empty cell and push
                # _head past _tail
                # benign-race: growth-rebind — torn vs _bind drops one flag
                end._blk[end._slot] = True
                return default
            mask = self._mask
            i = (head & mask) if mask >= 0 else (head % self._cap)
            item = self._buf[i]
            self._buf[i] = None
            self._head = head + 1
        tc_arr = end._tc     # array ref before slot (see try_push)
        byt_arr = end._byt
        slot = end._slot
        # benign-race: copy-and-zero — an increment racing the monitor's
        # sample costs at most one period; growth-rebind covers regrows
        tc_arr[slot] += 1.0
        nbytes = self.item_bytes
        if nbytes:
            # benign-race: copy-and-zero — same one-period tolerance
            byt_arr[slot] += nbytes
        return item

    def pop(self, timeout: Optional[float] = None):
        """Blocking pop; returns the item (which may itself be ``None``)
        or ``None`` on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        backoff = 1e-6
        while True:
            item = self.try_pop(_EMPTY)
            if item is not _EMPTY:
                return item
            if deadline is not None and time.monotonic() > deadline:
                return None
            time.sleep(backoff)
            backoff = min(backoff * 2, 1e-3)

    # ---------------- monitor / controller ----------------------------------
    @property
    def capacity(self) -> int:
        return self._cap

    def occupancy(self) -> float:
        """Fill fraction (len/capacity) — the admission legs' per-queue
        operand.  Unsynchronized like ``__len__``: a momentary race with
        a push/pop/resize reads one item stale, which the decision
        step's confirmation counters absorb."""
        cap = self._cap
        return len(self) / cap if cap > 0 else 0.0

    def __len__(self) -> int:
        # unsynchronized reads: a pop or resize rebase between loading
        # _tail and _head can make the difference momentarily negative
        return max(self._tail - self._head, 0)

    def resize(self, new_capacity: int) -> bool:
        """Controller-driven re-allocation (the paper resizes out-bound
        queues both to tune and to create observation windows).  Returns
        False for rejected requests — capacity < 1, or a shrink below
        the number of queued items (items are never dropped)."""
        if new_capacity < 1:
            return False
        with self._resize_lock:
            items = [self._buf[i % self._cap]
                     for i in range(self._head, self._tail)]
            if len(items) > new_capacity:
                return False  # never drop
            self._buf = items + [None] * (new_capacity - len(items))
            self._cap = new_capacity
            self._mask = _mask_for(new_capacity)
            self._tail = len(items)
            self._head = 0
        return True

    def close(self) -> None:
        """Retire both ends' arena slots (idempotent).  The queue must
        not be used afterwards — the slots may back new queues.  Raises
        while a live ``FleetMonitorService`` still monitors the queue.
        Slots are also auto-released when the queue is garbage collected
        (the service holds the ends alive, so monitored slots never get
        recycled under a live collector)."""
        self.head.release()
        self.tail.release()
