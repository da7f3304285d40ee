"""Asynchronous completion delivery: work requests and completion queues.

Verbs semantics over the simulated fabric:

* ``post_write()`` / ``post_read()`` return immediately with a
  :class:`WorkRequest` future — nothing blocks on the page-fault handling
  happening inside the fabric.
* When a transfer's last block is ACKed, a :class:`WorkCompletion` is
  delivered to the :class:`CompletionQueue` the request was posted
  against.  Callers either ``cq.poll(max_entries)`` (non-blocking batch
  drain, the CQ-polling hot loop of real RDMA apps) or
  ``cq.wait(n, deadline_us)`` (advance simulated time until ``n``
  completions are available or the deadline passes).
* Each CQ caps its **outstanding** work requests; posting beyond the cap
  raises :class:`WorkQueueFull` — backpressure, instead of the unbounded
  submission the old engine allowed.
"""

from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import TYPE_CHECKING, Optional

from repro_torch.errors import ConfigError, LivelockError

if TYPE_CHECKING:                                    # pragma: no cover
    from repro_torch.api.fabric import Fabric
    from repro_torch.core.node import Transfer, TransferStats


# livelock backstop for the wait loops, mirroring EventLoop.run()'s budget
MAX_WAIT_EVENTS = 50_000_000


def _advance_until(loop, done, deadline_us: float, max_events: int) -> bool:
    """Step the event loop until ``done()`` holds.

    Returns False if the loop drained or the (virtual-time) deadline passed
    first; raises if the event budget trips (zero-delay livelock).
    """
    deadline = loop.now + deadline_us
    steps = 0
    while not done():
        t_next = loop.peek_time()
        if t_next is None or t_next > deadline:
            return False
        loop.step()
        steps += 1
        if steps >= max_events:
            raise LivelockError("event budget exhausted — livelock?")
    return True


class WorkQueueFull(RuntimeError):
    """Posting would exceed the CQ's outstanding-work-request cap."""


class DomainQuotaExceeded(WorkQueueFull):
    """Posting would exceed the domain's outstanding-block quota.

    Raised by the posting verbs when the sending node's DMA arbiter
    reports the protection domain at its ``max_outstanding_blocks``
    (:class:`~repro_torch.api.policy.FaultPolicy`) — per-tenant backpressure,
    so one tenant's backlog can't grow without bound inside the fabric.
    """


class TenantQuotaExceeded(WorkQueueFull):
    """Posting (or opening a domain) would exceed a node's shared tenancy
    resources (``repro_torch.tenancy``).

    Raised by the posting verbs when the destination node's shared
    receive queue (SRQ) cannot grant the transfer's receive entries —
    ``FabricConfig(srq_entries=...)``, with ``srq_gold_reserve`` entries
    usable only by GOLD tenants — and by ``Fabric.open_domain`` when a
    node is at its ``tenants_per_node`` admission cap (or its GOLD-bank
    ceiling).  Subclasses :class:`WorkQueueFull` so generic backpressure
    handlers retry it like any other quota signal.
    """


class TrIdExhausted(WorkQueueFull):
    """Posting would launch blocks with no free 14-bit transaction ID.

    The wire protocol's ``tr_ID`` field (Table 3.2) bounds a node to 2^14
    blocks in flight; IDs recycle only when blocks complete.  The posting
    verbs raise this *node-wide* backpressure signal — subclassing
    :class:`WorkQueueFull`, so generic backpressure handlers retry it —
    when the launching node's pool is empty.  Work already accepted is
    never lost to exhaustion: launches that race the pool internally are
    deferred inside the R5 and redeemed as completions free IDs (visible
    as ``TrIdStats.stalls``).
    """


class WROpcode(enum.Enum):
    WRITE = "write"
    READ = "read"


class WCStatus(enum.Enum):
    """Terminal status of a work request (the verbs ``wc_status`` field).

    ``SUCCESS`` was the only member before the crash-fault layer: a
    permanently-stuck transfer was observable only as a CQ ``wait``
    deadline expiry.  The error members mirror the ibverbs statuses that
    "The Impact of RDMA on Agreement" identifies as the failure-semantics
    contract RDMA protocols build on:

    * ``RETRY_EXC_ERR`` — the R5 retransmission timer exhausted the
      domain's retry budget (``FaultPolicy.max_retries``) while the peer
      stayed reachable (e.g. a destination page fault that never
      resolves).
    * ``WR_FLUSH_ERR`` — the WR was flushed without ever being attempted
      to completion: its source node crashed mid-flight, or
      ``Fabric.close_domain`` tore down a domain whose in-flight WRs
      target a crashed/unreachable peer.
    * ``REMOTE_OP_ERR`` — the remote end is dead or unreachable: the
      R5 saw ``crash_detect_retries`` consecutive timeout rounds with the
      peer down/partitioned (``FabricConfig.crash_detect_retries``).
    """

    SUCCESS = "success"
    RETRY_EXC_ERR = "retry_exc_err"
    WR_FLUSH_ERR = "wr_flush_err"
    REMOTE_OP_ERR = "remote_op_err"


@dataclasses.dataclass(frozen=True)
class WorkCompletion:
    """One CQ entry: the terminal record of a work request."""
    wr_id: int
    opcode: WROpcode
    status: WCStatus
    pd: int
    nbytes: int
    t_posted: float
    t_complete: float
    stats: "TransferStats"

    @property
    def latency_us(self) -> float:
        return self.t_complete - self.t_posted

    @property
    def ok(self) -> bool:
        return self.status is WCStatus.SUCCESS


class WorkRequest:
    """Future handed back by ``post_write()`` / ``post_read()``."""

    __slots__ = ("wr_id", "opcode", "cq", "transfer", "t_posted",
                 "completion")

    def __init__(self, wr_id: int, opcode: WROpcode, cq: "CompletionQueue",
                 transfer: "Transfer", t_posted: float):
        self.wr_id = wr_id
        self.opcode = opcode
        self.cq = cq
        self.transfer = transfer
        self.t_posted = t_posted
        self.completion: Optional[WorkCompletion] = None

    @property
    def done(self) -> bool:
        return self.completion is not None

    @property
    def stats(self) -> "TransferStats":
        """Live per-transfer statistics (valid during and after flight)."""
        return self.transfer.stats

    def result(self, deadline_us: float = 5e6,
               max_events: int = MAX_WAIT_EVENTS) -> WorkCompletion:
        """Advance simulated time until THIS request completes.

        The completion stays queued on the CQ for ``poll()``/``wait()`` —
        ``result()`` only waits for it, mirroring how a verbs app can watch
        one WR while a poller thread drains the CQ.
        """
        if not _advance_until(self.cq.fabric.loop,
                              lambda: self.completion is not None,
                              deadline_us, max_events):
            raise TimeoutError(
                f"wr_id={self.wr_id} incomplete after {deadline_us} us: "
                f"stats={self.transfer.stats}")
        return self.completion


@dataclasses.dataclass
class CQStats:
    posted: int = 0
    completed: int = 0
    polls: int = 0
    empty_polls: int = 0
    max_queued: int = 0
    rejected_posts: int = 0      # WorkQueueFull backpressure events
    deadline_expiries: int = 0   # wait() returns that hit the deadline


class CompletionQueue:
    """Bounded queue of :class:`WorkCompletion` entries.

    ``max_outstanding`` (default: ``depth``) bounds in-flight work
    requests so the CQ can never overflow: completions occupy at most the
    slots the poster was granted.
    """

    def __init__(self, fabric: "Fabric", depth: int = 256,
                 max_outstanding: Optional[int] = None):
        if max_outstanding is None:
            max_outstanding = depth
        if max_outstanding > depth:
            raise ConfigError(
                f"max_outstanding={max_outstanding} > depth={depth} could "
                f"overflow the CQ")
        self.fabric = fabric
        self.depth = depth
        self.max_outstanding = max_outstanding
        self.outstanding = 0
        self.stats = CQStats()
        self._entries: deque[WorkCompletion] = deque()

    def __len__(self) -> int:
        return len(self._entries)

    # ------------------------------------------------------------- posting
    def on_post(self) -> None:
        """Reserve an outstanding slot (called by the posting verbs)."""
        if self.outstanding >= self.max_outstanding:
            self.stats.rejected_posts += 1
            raise WorkQueueFull(
                f"{self.outstanding} work requests outstanding "
                f"(cap {self.max_outstanding}); poll the CQ first")
        self.outstanding += 1
        self.stats.posted += 1

    def deliver(self, wc: WorkCompletion) -> None:
        """Completion arrival (called by the fabric at ACK time).

        The outstanding slot is NOT freed here: a queued completion still
        occupies its CQ slot until the application drains it, which is what
        keeps ``len(cq) <= max_outstanding <= depth`` an invariant.
        """
        self._entries.append(wc)
        self.stats.completed += 1
        self.stats.max_queued = max(self.stats.max_queued,
                                    len(self._entries))

    # ------------------------------------------------------------ draining
    def poll(self, max_entries: int = 16) -> list[WorkCompletion]:
        """Non-blocking batch drain of up to ``max_entries`` completions."""
        self.stats.polls += 1
        if not self._entries:
            self.stats.empty_polls += 1
            return []
        out = []
        while self._entries and len(out) < max_entries:
            out.append(self._entries.popleft())
            self.outstanding -= 1           # drained entry frees its slot
        return out

    def wait(self, n: int = 1, deadline_us: float = 5e6,
             max_events: int = MAX_WAIT_EVENTS) -> list[WorkCompletion]:
        """Advance simulated time until ``n`` completions are queued (or the
        deadline passes), then drain and return up to ``n`` of them.

        May return fewer than ``n`` entries if the deadline expires first —
        callers check ``len()`` (and ``stats.deadline_expiries``), as with
        a timed verbs CQ wait.
        """
        loop = self.fabric.loop
        if not _advance_until(loop, lambda: len(self._entries) >= n,
                              deadline_us, max_events) \
                and loop.peek_time() is not None:
            # events remain past the deadline: a genuine expiry (a
            # drained loop just means no more completions will ever come)
            self.stats.deadline_expiries += 1
        return self.poll(max_entries=n)
