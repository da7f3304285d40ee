"""Deterministic discrete-event simulation kernel.

Pure virtual time (microseconds, float).  No wall-clock, no randomness
unless a seeded RNG is explicitly passed to a component — identical inputs
give identical traces, which the property tests rely on.

Two interchangeable queue implementations share the :class:`Event`
contract and the frozen ``(time, seq)`` tie-break (same-time events fire
in schedule order, always):

* :class:`EventLoop` — the default **bucketed event wheel** (calendar
  queue).  The protocol's delay spectrum is dominated by a few classes —
  sub-microsecond driver/completion hops, the 0.1 us link hop, the
  200 us poll cadence, the 1 ms retransmission timeout — so almost every
  event lands within a few thousand microseconds of *now*.  The wheel
  covers that horizon with fixed-width buckets; only the far tail (lease
  expiries, long arrival periods) pays for a real heap.
* :class:`HeapEventLoop` — the previous global binary heap, kept as the
  A/B reference behind ``REPRO_EVENT_LOOP=heap`` (the equivalence
  property tests drive both and assert identical traces).

``make_event_loop()`` picks by the ``REPRO_EVENT_LOOP`` environment
variable; :class:`repro_torch.api.fabric.Fabric` goes through it.
"""

from __future__ import annotations

import heapq
import itertools
import os
from typing import Any, Callable, Optional


class Event:
    __slots__ = ("time", "seq", "fn", "args", "cancelled", "loop")

    def __init__(self, time: float, seq: int, fn: Callable[..., Any],
                 args: tuple, loop: "Optional[EventLoop]" = None):
        self.time = time
        self.seq = seq
        self.fn = fn
        self.args = args
        self.cancelled = False
        self.loop = loop

    def cancel(self) -> None:
        if not self.cancelled:
            self.cancelled = True
            if self.loop is not None:
                self.loop._n_cancelled += 1

    def __lt__(self, other: "Event") -> bool:
        return (self.time, self.seq) < (other.time, other.seq)


#: allocation shortcut for the schedule() hot path: build the Event with
#: direct slot stores instead of an ``__init__`` frame (identical object)
_EVENT_NEW = Event.__new__


# ---------------------------------------------------------------- wheel
#: bucket width in virtual microseconds.  A power of two, so the index
#: computation ``int(t * _WHEEL_INV)`` is an exact binary scale of the
#: float timestamp: two timestamps compare the same way their bucket
#: indices do, which is what keeps cross-bucket ordering exact.
WHEEL_BUCKET_US = 8.0
_WHEEL_INV = 1.0 / WHEEL_BUCKET_US          # exact (power of two)
#: wheel span in buckets (power of two).  8192 us of horizon: the poll
#: cadence (200 us), every driver/wire delay and the 1 ms timeout round
#: all land in-wheel; only lease expiries and long open-loop arrival
#: periods overflow to the far-future heap.
WHEEL_SPAN = 1024
_WHEEL_MASK = WHEEL_SPAN - 1


class EventLoop:
    """Bucketed event wheel (calendar queue), the default kernel.

    Three tiers, ordered by distance from *now*:

    * ``_active`` — a small binary heap of ``(time, seq, Event)`` entries
      holding every event of the *current* bucket.  Pops come from here;
      new events that land at or before the current bucket are pushed
      here, so intra-bucket ordering is exact.
    * ``_buckets`` — ``WHEEL_SPAN`` unsorted append-only lists covering
      the next ``WHEEL_SPAN × WHEEL_BUCKET_US`` microseconds.  Scheduling
      into the window is an O(1) append; a bucket is heapified once, when
      it becomes current.  ``_pending_buckets`` is a heap of the
      *non-empty* bucket indices, so advancing skips empty buckets in
      O(log buckets-in-use) instead of scanning.
    * ``_overflow`` — a binary heap for events beyond the window (the
      far-future tail); entries migrate into ``_active`` when their
      bucket comes up.

    Cancelled events (every ACKed block cancels its 1 ms timeout) are
    reclaimed in bulk when their bucket activates — the filter happens
    *before* the heapify, so, unlike the heap loop, a cancelled timeout
    never costs a single sift.  ``compactions`` counts those bulk sweeps.

    The ``(time, seq)`` tie-break contract is frozen: same-time events
    fire in schedule-sequence order, bit-identical to the heap loop (the
    ``tests/test_event_loop_equiv.py`` property drives both).
    """

    #: kept for API parity with the heap loop (compaction threshold there)
    COMPACT_MIN = 1024

    def __init__(self):
        self.now: float = 0.0
        self._seq = itertools.count()
        self._active: list[tuple[float, int, Event]] = []
        self._cur = 0                 # absolute index of the active bucket
        self._buckets: list[list] = [[] for _ in range(WHEEL_SPAN)]
        self._pending_buckets: list[int] = []   # heap of non-empty indices
        self._overflow: list[tuple[float, int, Event]] = []
        self._n_queued = 0            # entries enqueued (incl. cancelled)
        self._n_cancelled = 0         # cancelled events still enqueued
        self.events_processed = 0
        self.compactions = 0          # bulk cancelled-entry sweeps

    def schedule(self, delay: float, fn: Callable[..., Any], *args: Any) -> Event:
        assert delay >= 0, f"negative delay {delay}"
        t = self.now + delay
        seq = next(self._seq)
        ev = _EVENT_NEW(Event)
        ev.time = t
        ev.seq = seq
        ev.fn = fn
        ev.args = args
        ev.cancelled = False
        ev.loop = self
        b = int(t * _WHEEL_INV)
        cur = self._cur
        if b <= cur:
            heapq.heappush(self._active, (t, seq, ev))
        elif b - cur < WHEEL_SPAN:
            lst = self._buckets[b & _WHEEL_MASK]
            if not lst:
                # bucket indices are pushed only on an empty->non-empty
                # transition, so every entry in this heap is unique
                # torch-lint: allow(det-heap-tiebreak): unique int keys, no tie
                heapq.heappush(self._pending_buckets, b)
            lst.append((t, seq, ev))
        else:
            heapq.heappush(self._overflow, (t, seq, ev))
        self._n_queued += 1
        return ev

    def at(self, time: float, fn: Callable[..., Any], *args: Any) -> Event:
        return self.schedule(max(0.0, time - self.now), fn, *args)

    def _refill(self) -> bool:
        """Advance to the next non-empty bucket; False when drained.

        Structural only: ``now`` does not move until an event fires, so
        ``peek_time()`` may refill without advancing the clock.
        """
        while not self._active:
            pend = self._pending_buckets
            over = self._overflow
            if pend:
                b = pend[0]
                if over:
                    b2 = int(over[0][0] * _WHEEL_INV)
                    if b2 < b:
                        b = b2
            elif over:
                b = int(over[0][0] * _WHEEL_INV)
            else:
                return False
            self._cur = b
            if pend and pend[0] == b:
                heapq.heappop(pend)
                slot = self._buckets[b & _WHEEL_MASK]
                active = [e for e in slot if not e[2].cancelled]
                swept = len(slot) - len(active)
                if swept:
                    self._n_queued -= swept
                    self._n_cancelled -= swept
                    self.compactions += 1
                del slot[:]
                heapq.heapify(active)
            else:
                active = []
            while over and int(over[0][0] * _WHEEL_INV) == b:
                # torch-lint: allow(det-heap-tiebreak): migrates an existing (time, seq, Event) tuple between tiers — seq is the tie-break
                heapq.heappush(active, heapq.heappop(over))
            self._active = active
        return True

    def run(self, until: Optional[float] = None, max_events: int = 50_000_000) -> None:
        """Run until drained / past ``until``; ``max_events`` bounds THIS
        call (a livelock guard, not a cumulative-counter trip wire)."""
        fired = 0
        heappop = heapq.heappop
        while True:
            active = self._active
            if not active:
                if not self._refill():
                    return
                active = self._active
            entry = heappop(active)
            ev = entry[2]
            if ev.cancelled:
                self._n_queued -= 1
                self._n_cancelled -= 1
                continue
            if until is not None and entry[0] > until:
                heapq.heappush(active, entry)
                return
            if fired >= max_events:
                heapq.heappush(active, entry)
                raise RuntimeError("event budget exhausted — livelock?")
            fired += 1
            self.now = entry[0]
            self.events_processed += 1
            self._n_queued -= 1
            ev.loop = None      # fired: a late cancel() must not count
            ev.fn(*ev.args)

    def run_batch(self, limit: int) -> int:
        """Fire up to ``limit`` live events; returns how many fired.

        The chunked-stepping API: harness driver loops (``soak()``) call
        this once per chunk instead of ``step()`` per event, keeping the
        per-event overhead inside the kernel's tight loop.  0 means the
        loop is drained.
        """
        fired = 0
        heappop = heapq.heappop
        while fired < limit:
            active = self._active
            if not active:
                if not self._refill():
                    break
                active = self._active
            t, _, ev = heappop(active)
            if ev.cancelled:
                self._n_queued -= 1
                self._n_cancelled -= 1
                continue
            self.now = t
            self.events_processed += 1
            self._n_queued -= 1
            ev.loop = None      # fired: a late cancel() must not count
            ev.fn(*ev.args)
            fired += 1
        return fired

    def peek_time(self) -> Optional[float]:
        """Time of the next live event, or None if the loop is drained."""
        while True:
            active = self._active
            if not active:
                if not self._refill():
                    return None
                active = self._active
            if active[0][2].cancelled:
                heapq.heappop(active)
                self._n_queued -= 1
                self._n_cancelled -= 1
                continue
            return active[0][0]

    def step(self) -> bool:
        """Execute exactly one live event.  Returns False if none remain.

        Lets completion-queue ``wait()`` stop the clock at the instant a
        completion is delivered instead of free-running to a deadline.
        """
        return self.run_batch(1) == 1

    @property
    def idle(self) -> bool:
        # the counters make this O(1): live = queued - cancelled
        return self._n_queued <= self._n_cancelled


class HeapEventLoop(EventLoop):
    """Global binary-heap event queue — the pre-wheel kernel, kept as the
    A/B reference (``REPRO_EVENT_LOOP=heap``).

    * **Tuple-keyed heap** — entries are ``(time, seq, Event)``, so sift
      comparisons resolve on the C-level float/int compare (``seq`` is
      unique, the :class:`Event` is never compared).  The seed heaped
      ``Event`` objects directly, paying a Python ``__lt__`` call per
      comparison — the single hottest function at scale.
    * **Lazy-cancel compaction** — cancelled events (every ACKed block
      cancels its 1 ms retransmission timeout) stay heaped until their
      timestamp; under a million-block soak they would dominate the heap
      and tax every push/pop with a larger log factor.  The loop counts
      live cancellations and rebuilds the heap whenever cancelled entries
      outnumber live ones: an amortized-O(1) sweep keeping heap
      operations sized to *live* work.
    """

    #: don't bother compacting heaps smaller than this
    COMPACT_MIN = 1024

    def __init__(self):
        self.now: float = 0.0
        self._heap: list[tuple[float, int, Event]] = []
        self._seq = itertools.count()
        self._n_cancelled = 0         # cancelled events still in the heap
        self.events_processed = 0
        self.compactions = 0

    def schedule(self, delay: float, fn: Callable[..., Any], *args: Any) -> Event:
        assert delay >= 0, f"negative delay {delay}"
        t = self.now + delay
        seq = next(self._seq)
        ev = _EVENT_NEW(Event)
        ev.time = t
        ev.seq = seq
        ev.fn = fn
        ev.args = args
        ev.cancelled = False
        ev.loop = self
        heap = self._heap
        if self._n_cancelled > self.COMPACT_MIN \
                and self._n_cancelled * 2 > len(heap):
            self._heap = heap = [h for h in heap if not h[2].cancelled]
            heapq.heapify(heap)
            self._n_cancelled = 0
            self.compactions += 1
        heapq.heappush(heap, (t, seq, ev))
        return ev

    def run(self, until: Optional[float] = None, max_events: int = 50_000_000) -> None:
        fired = 0
        heap = self._heap
        while heap:
            entry = heapq.heappop(heap)
            ev = entry[2]
            if ev.cancelled:
                self._n_cancelled -= 1
                continue
            if until is not None and entry[0] > until:
                heapq.heappush(heap, entry)
                return
            if fired >= max_events:
                # the budget bounds THIS call, not the loop's lifetime —
                # a long soak followed by a later run() must not trip it
                heapq.heappush(heap, entry)
                raise RuntimeError("event budget exhausted — livelock?")
            fired += 1
            self.now = entry[0]
            self.events_processed += 1
            ev.loop = None      # fired: a late cancel() must not count
            ev.fn(*ev.args)
            heap = self._heap   # schedule() may have compacted

    def run_batch(self, limit: int) -> int:
        fired = 0
        heap = self._heap
        while fired < limit and heap:
            t, _, ev = heapq.heappop(heap)
            if ev.cancelled:
                self._n_cancelled -= 1
                continue
            self.now = t
            self.events_processed += 1
            ev.loop = None      # fired: a late cancel() must not count
            ev.fn(*ev.args)
            fired += 1
            heap = self._heap   # schedule() may have compacted
        return fired

    def peek_time(self) -> Optional[float]:
        """Time of the next live event, or None if the loop is drained."""
        heap = self._heap
        while heap and heap[0][2].cancelled:
            heapq.heappop(heap)
            self._n_cancelled -= 1
        return heap[0][0] if heap else None

    def step(self) -> bool:
        """Execute exactly one live event.  Returns False if none remain."""
        while self._heap:
            t, _, ev = heapq.heappop(self._heap)
            if ev.cancelled:
                self._n_cancelled -= 1
                continue
            self.now = t
            self.events_processed += 1
            ev.loop = None      # fired: a late cancel() must not count
            ev.fn(*ev.args)
            return True
        return False

    @property
    def idle(self) -> bool:
        # the cancellation counter makes this O(1): live = total - cancelled
        return len(self._heap) <= self._n_cancelled


def make_event_loop() -> EventLoop:
    """The configured kernel: the wheel, or ``REPRO_EVENT_LOOP=heap`` for
    the legacy binary heap (A/B comparisons, bisecting a trace diff)."""
    kind = os.environ.get("REPRO_EVENT_LOOP", "wheel")
    if kind == "heap":
        return HeapEventLoop()
    if kind not in ("", "wheel"):
        raise ValueError(
            f"REPRO_EVENT_LOOP must be 'wheel' or 'heap', got {kind!r}")
    return EventLoop()


class Resource:
    """A serially-occupied resource (a CPU core, a link).

    ``reserve(duration)`` books the next available slot at or after *now*
    and returns ``(start, end)``; callers schedule their completion events
    at ``end``.  ``busy_overlap`` reports whether the reservation had to
    queue — the link-interleaving signal used by the PLDMA model.
    """

    def __init__(self, loop: EventLoop, name: str = ""):
        self.loop = loop
        self.name = name
        self.busy_until: float = 0.0
        self.busy_time: float = 0.0
        self.reservations = 0

    def reserve(self, duration: float) -> tuple[float, float]:
        start = self.loop.now
        if self.busy_until > start:
            start = self.busy_until
        end = start + duration
        self.busy_until = end
        self.busy_time += duration
        self.reservations += 1
        return start, end

    def would_queue(self) -> bool:
        return self.busy_until > self.loop.now
