"""Sharded per-node event processing (opt-in, ``FabricConfig(shards=)``).

The single :class:`~repro_torch.core.simulator.EventLoop` wheel serializes the
whole fabric through one queue.  This module partitions the fabric's
nodes into ``shards`` groups, each owning a private bucketed wheel, and
merges them under the classic conservative-lookahead rule
(Chandy–Misra–Bryant): with

    lookahead = min routed link latency  (one hop, ``hop_latency_us``)

no shard can receive a cross-shard event earlier than
``min(head of every shard) + lookahead``, because every cross-node
message must cross at least one physical link.  ``safe_horizon()``
exposes that bound — a parallel executor may run every shard to it
without inter-shard synchronization.

The sequential executor below fires events strictly in global
``(time, seq)`` order (shards share one sequence counter and one
clock), so a sharded fabric is **byte-identical** to the single-wheel
fabric on every topology — the equivalence tests in
``tests/test_sharded.py`` assert exactly that.  What sharding buys
today is bounded per-queue size (each wheel holds only its nodes'
events) and the scaffold for parallel execution; the lookahead rule is
the contract a threaded or multi-process driver would build on.

The partitioning idiom — one host presenting N logical execution
shards, selected by a config knob — follows the JAX host-platform
device-count pattern (``xla_force_host_platform_device_count``; see
SNIPPETS.md snippet 1): the topology of the work does not change, only
how many queues serve it.

Shard assignment is ``node_id % shards``: round-robin keeps
neighbouring torus/ring nodes in *different* shards, which is the
adversarial case for the lookahead rule and therefore the one the
equivalence tests exercise.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Optional

from repro_torch.core.simulator import Event, EventLoop


class _ShardWheel(EventLoop):
    """One shard's bucketed wheel, sharing the parent's clock and the
    global schedule-sequence counter (the frozen ``(time, seq)``
    tie-break must stay *global*, or same-time events in different
    shards would lose their schedule-order contract)."""

    def __init__(self, parent: "ShardedEventLoop"):
        self.parent = parent        # before super(): the clock property
        super().__init__()
        self._seq = parent._seq     # shared global sequence counter

    @property
    def now(self) -> float:
        return self.parent.now

    @now.setter
    def now(self, t: float) -> None:
        self.parent.now = t


class ShardHandle:
    """A node-facing facade of one shard: ``schedule``/``at`` land in
    the shard's wheel (and refresh the parent's head cache); clock and
    drain queries delegate to the parent, so protocol code is oblivious
    to whether it runs sharded."""

    __slots__ = ("parent", "wheel", "index")

    def __init__(self, parent: "ShardedEventLoop", index: int):
        self.parent = parent
        self.index = index
        self.wheel = parent.shards[index]

    @property
    def now(self) -> float:
        return self.parent.now

    def schedule(self, delay: float, fn: Callable[..., Any],
                 *args: Any) -> Event:
        ev = self.wheel.schedule(delay, fn, *args)
        heads = self.parent._heads
        h = heads[self.index]
        if h is None or ev.time < h[0] or (ev.time == h[0]
                                           and ev.seq < h[1]):
            heads[self.index] = (ev.time, ev.seq)
        return ev

    def at(self, time: float, fn: Callable[..., Any], *args: Any) -> Event:
        return self.schedule(max(0.0, time - self.parent.now), fn, *args)

    # drain/introspection: the per-shard view is not meaningful to
    # protocol code — answer for the whole fabric
    def run(self, until: Optional[float] = None,
            max_events: int = 50_000_000) -> None:
        self.parent.run(until=until, max_events=max_events)

    def run_batch(self, limit: int) -> int:
        return self.parent.run_batch(limit)

    def step(self) -> bool:
        return self.parent.step()

    def peek_time(self) -> Optional[float]:
        return self.parent.peek_time()

    @property
    def idle(self) -> bool:
        return self.parent.idle

    @property
    def events_processed(self) -> int:
        return self.parent.events_processed


class ShardedEventLoop:
    """``EventLoop``-compatible facade over N per-shard wheels.

    Firing is a head-merge: the cached ``(time, seq)`` head of every
    shard is scanned, the globally smallest is validated against its
    wheel (cancellations make cached heads stale-early, never
    stale-late) and fired.  Handlers scheduling into any shard refresh
    that shard's cached head through their :class:`ShardHandle`, so the
    cache is always conservative and the merge never misses an event.
    """

    def __init__(self, n_shards: int, lookahead_us: float):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if lookahead_us <= 0:
            raise ValueError(
                f"lookahead_us must be > 0 (the minimum routed link "
                f"latency), got {lookahead_us}")
        self.now: float = 0.0
        self.lookahead_us = lookahead_us
        self._seq = itertools.count()
        self.shards = [_ShardWheel(self) for _ in range(n_shards)]
        self._heads: list[Optional[tuple[float, int]]] = [None] * n_shards
        self._handles = [ShardHandle(self, i) for i in range(n_shards)]

    # ------------------------------------------------------------ wiring
    def handle_for(self, node_id: int) -> ShardHandle:
        """The :class:`ShardHandle` serving ``node_id`` (round-robin)."""
        return self._handles[node_id % len(self.shards)]

    # ------------------------------------------------------------- heads
    def _refresh(self, i: int) -> Optional[tuple[float, int]]:
        wheel = self.shards[i]
        if wheel.peek_time() is None:
            self._heads[i] = None
            return None
        entry = wheel._active[0]
        head = (entry[0], entry[1])
        self._heads[i] = head
        return head

    def _select(self) -> int:
        """Index of the shard holding the globally next live event, or
        -1 when every shard is drained.  Cached heads can be stale-early
        (their event was cancelled); validate-and-rescan fixes that."""
        heads = self._heads
        while True:
            best = -1
            best_head = None
            for i, h in enumerate(heads):
                if h is not None and (best_head is None or h < best_head):
                    best_head = h
                    best = i
            if best < 0:
                return -1
            if self._refresh(best) == best_head:
                return best
            # stale head (cancelled/compacted): rescan with it corrected

    # ---------------------------------------------------------- execution
    def run(self, until: Optional[float] = None,
            max_events: int = 50_000_000) -> None:
        fired = 0
        while True:
            i = self._select()
            if i < 0:
                return
            if until is not None and self._heads[i][0] > until:
                return
            if fired >= max_events:
                raise RuntimeError("event budget exhausted — livelock?")
            fired += 1
            self.shards[i].run_batch(1)
            self._refresh(i)

    def run_batch(self, limit: int) -> int:
        fired = 0
        while fired < limit:
            i = self._select()
            if i < 0:
                break
            self.shards[i].run_batch(1)
            self._refresh(i)
            fired += 1
        return fired

    def step(self) -> bool:
        return self.run_batch(1) == 1

    def peek_time(self) -> Optional[float]:
        i = self._select()
        return None if i < 0 else self._heads[i][0]

    def safe_horizon(self) -> Optional[float]:
        """The conservative-lookahead bound: every shard may execute all
        its events strictly below this time with no inter-shard merge —
        no cross-shard event can arrive earlier, because it must cross
        at least one link (``lookahead_us`` = min routed link latency).
        ``None`` when the fabric is drained."""
        t = self.peek_time()
        return None if t is None else t + self.lookahead_us

    # ------------------------------------------- fabric-level scheduling
    # (post verbs, harness timers — routed to shard 0; any shard works,
    # the merge preserves global order regardless of placement)
    def schedule(self, delay: float, fn: Callable[..., Any],
                 *args: Any) -> Event:
        return self._handles[0].schedule(delay, fn, *args)

    def at(self, time: float, fn: Callable[..., Any], *args: Any) -> Event:
        return self._handles[0].at(time, fn, *args)

    # --------------------------------------------------------- accounting
    @property
    def idle(self) -> bool:
        return all(w._n_queued <= w._n_cancelled for w in self.shards)

    @property
    def events_processed(self) -> int:
        return sum(w.events_processed for w in self.shards)

    @property
    def compactions(self) -> int:
        return sum(w.compactions for w in self.shards)
