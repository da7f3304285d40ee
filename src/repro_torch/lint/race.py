"""Same-timestamp race sanitizer — dynamic companion to the linter.

The EventLoop orders same-time events by their schedule sequence
number, so any given binary is deterministic.  But code that *relies*
on that tie order is a trap for the planned event-loop rewrite: change
the tie-break (bucket queues, batch execution) and stats shift with no
test failing loudly.  This instrumentation makes tie-order reliance
visible *now*:

* every fired event gets a **footprint** — sets of resource keys it
  reads and writes;
* events that fire at the same virtual timestamp form a group;
* two events in one group **conflict** if one writes a key the other
  reads or writes — their relative order is load-bearing, which is
  exactly what a tie-order change would scramble.

Footprints resolve in order:

1. a ``__race_footprint__(args) -> (reads, writes)`` attribute on the
   callback (how tests plant known races);
2. a ``FOOTPRINTS[qualname]`` registry entry, same signature;
3. generically, from the arguments: a Block-like argument (has
   ``tr_id``/``round_id``/``transfer``) contributes a write on its
   stable ``(transfer.tid, block.index)`` key, a Transfer-like argument
   (has ``tid``/``blocks``) a write on the WR key.  Note the keys are
   derived from protocol identity, never ``id()`` — the same rule the
   static ``det-id-order`` pass enforces.

Callbacks with no resolvable footprint contribute nothing; they are
tallied in ``unknown_callbacks`` so coverage erosion is observable.

Opt-in via ``FabricConfig(race_check=True)`` or ``REPRO_RACE_CHECK=1``;
``repro_torch.testing.soak`` folds the reports into its violation list.  The
hook only *observes* (footprints are computed before the event body
runs and never touch simulator state), so an instrumented run's stats
stay byte-identical to an uninstrumented one.
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Callable, Dict, FrozenSet, List, Set, Tuple

from repro_torch.core.simulator import Event, EventLoop

Footprint = Tuple[FrozenSet[Any], FrozenSet[Any]]   # (reads, writes)

#: qualname -> footprint fn; extension point for callbacks whose
#: touch-set the generic argument scan cannot see
FOOTPRINTS: Dict[str, Callable[[tuple], Footprint]] = {}

_EMPTY: Footprint = (frozenset(), frozenset())


def _generic_footprint(args: tuple) -> Footprint:
    writes: Set[Any] = set()
    for a in args:
        if hasattr(a, "tr_id") and hasattr(a, "round_id") \
                and hasattr(a, "transfer"):          # Block
            writes.add(("block", a.transfer.tid, a.index))
        elif hasattr(a, "tid") and hasattr(a, "blocks"):   # Transfer
            writes.add(("wr", a.tid))
    return (frozenset(), frozenset(writes))


def footprint_of(fn: Callable, args: tuple) -> Tuple[Footprint, bool]:
    """(footprint, known?) for one event callback."""
    hook = getattr(fn, "__race_footprint__", None)
    if hook is not None:
        return hook(args), True
    qn = getattr(fn, "__qualname__", "")
    reg = FOOTPRINTS.get(qn)
    if reg is not None:
        return reg(args), True
    fp = _generic_footprint(args)
    return fp, bool(fp[0] or fp[1])


class RaceCheckLoop(EventLoop):
    """Drop-in EventLoop that audits same-timestamp event groups."""

    #: cap reports per run — one bad tie pattern repeats thousands of
    #: times in a soak and the first few instances say everything
    MAX_REPORTS = 32

    def __init__(self) -> None:
        super().__init__()
        self.reports: List[str] = []
        self.unknown_callbacks: Counter = Counter()
        self.groups_checked = 0
        self._group_time: float = -1.0
        #: (label, reads, writes) of the current same-time group
        self._group: List[Tuple[str, FrozenSet[Any], FrozenSet[Any]]] = []

    # ------------------------------------------------------- observation
    def _observe(self, ev: Event) -> None:
        if ev.time != self._group_time:
            self.flush()
            self._group_time = ev.time
        (reads, writes), known = footprint_of(ev.fn, ev.args)
        if not known:
            self.unknown_callbacks[
                getattr(ev.fn, "__qualname__", repr(ev.fn))] += 1
        if reads or writes:
            label = getattr(ev.fn, "__qualname__", repr(ev.fn))
            self._group.append((label, reads, writes))

    def flush(self) -> None:
        """Close the current same-time group and report its conflicts."""
        group, t = self._group, self._group_time
        self._group = []
        if len(group) < 2:
            return
        self.groups_checked += 1
        for i, (la, ra, wa) in enumerate(group):
            if len(self.reports) >= self.MAX_REPORTS:
                return
            for lb, rb, wb in group[i + 1:]:
                clash = (wa & wb) | (wa & rb) | (wb & ra)
                if clash:
                    self.reports.append(
                        f"t={t:.3f}us: {la} and {lb} conflict on "
                        f"{sorted(clash)} — same-timestamp order is "
                        f"load-bearing")
                    break

    # ------------------------------------------- instrumented execution
    # run()/run_batch() are verbatim copies of the wheel EventLoop's with
    # the single _observe() hook before each dispatch — the base loop
    # keeps its hot path free of any hook indirection.  (step() comes
    # from the base class: it delegates to run_batch(1).)
    def run(self, until: float | None = None,
            max_events: int = 50_000_000) -> None:
        import heapq
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
            ev.loop = None
            self._observe(ev)
            ev.fn(*ev.args)

    def run_batch(self, limit: int) -> int:
        import heapq
        fired = 0
        heappop = heapq.heappop
        while fired < limit:
            active = self._active
            if not active:
                if not self._refill():
                    break
                active = self._active
            entry = heappop(active)
            ev = entry[2]
            if ev.cancelled:
                self._n_queued -= 1
                self._n_cancelled -= 1
                continue
            self.now = entry[0]
            self.events_processed += 1
            self._n_queued -= 1
            ev.loop = None
            self._observe(ev)
            ev.fn(*ev.args)
            fired += 1
        return fired
