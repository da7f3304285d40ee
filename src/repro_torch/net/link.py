"""Per-direction link resources and routed paths.

A :class:`Link` is ONE direction of one physical adjacency: a serially
occupied wire with microsecond-resolution reservation cursors, per-link
telemetry (:class:`LinkStats`) and the PLDMA interleave heuristic the
Fig 4.2 dampening model relies on.  A :class:`Path` is the routed chain
of links between two nodes; everything a node transmits — a page of
packets, an ACK, a NACK, a RAPF mailbox message — goes through a path,
so cross-tenant traffic meeting on a shared link genuinely contends.

**Service classes on the wire.**  With ``qos`` enabled (the default on
routed topologies) each link arbitrates like the DMA arbiter's class
scheme (:class:`~repro_torch.core.arbiter.ServiceClass`): LATENCY-class
reservations queue only behind other LATENCY traffic and *overtake* the
BULK backlog (which is pushed back by the stolen wire time), so
fault-resolution control packets stay bounded on hops congested by a
BULK retransmit storm.  With ``qos`` off (legacy ALL_TO_ALL) a link is a
single FIFO cursor — bit-for-bit the seed's behavior — and control
packets charge wire + routed distance without booking the link.

**Interleave hygiene** (ISSUE-4 satellite): ``last_user`` — the stream
identity used to detect two blocks interleaving their packets on one
wire — is cleared whenever the link has fully drained, so a stream that
finished long ago can never flag a later, lone stream as interleaved and
inflate its FIFO dedup-break pushes.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Hashable, Optional

if TYPE_CHECKING:                                    # pragma: no cover
    # type-only: repro_torch.net is the bottom layer — importing repro_torch.core at
    # runtime would pull core/__init__ -> engine -> api -> net back in
    from repro_torch.core.costmodel import CostModel
    from repro_torch.core.simulator import EventLoop


@dataclasses.dataclass(slots=True)
class LinkStats:
    """One direction's wire telemetry (all additive except the maxima)."""

    data_packets: int = 0        # page-stream reservations carried
    ctrl_packets: int = 0        # ACK/NACK/RAPF/read-request messages
    data_bytes: int = 0          # payload bytes serialized
    busy_us: float = 0.0         # wire time booked
    queued: int = 0              # reservations that had to wait
    queue_us: float = 0.0        # total waiting time
    max_queue_us: float = 0.0    # worst single wait (not additive)
    latency_overtakes: int = 0   # LATENCY reservations that jumped BULK
    interleaves: int = 0         # streams flagged interleaved here

    ADDITIVE = ("data_packets", "ctrl_packets", "data_bytes", "busy_us",
                "queued", "queue_us", "latency_overtakes", "interleaves")

    def as_dict(self) -> dict:
        return {
            "data_packets": self.data_packets,
            "ctrl_packets": self.ctrl_packets,
            "data_bytes": self.data_bytes,
            "busy_us": round(self.busy_us, 6),
            "queued": self.queued,
            "queue_us": round(self.queue_us, 6),
            "max_queue_us": round(self.max_queue_us, 6),
            "latency_overtakes": self.latency_overtakes,
            "interleaves": self.interleaves,
        }


class Link:
    """One direction of one physical adjacency (or a node's loopback).

    ``hops`` scales the propagation latency charged per traversal — 1 for
    a real physical link; the legacy ALL_TO_ALL topology keeps the seed's
    ``FabricConfig.hops`` alias by building direct links with
    ``hops=config.hops``.
    """

    __slots__ = ("loop", "cost", "src", "dst", "hops", "qos",
                 "busy_until", "lat_busy_until", "last_user", "stats")

    def __init__(self, loop: EventLoop, cost: CostModel, src: int, dst: int,
                 hops: int = 1, qos: bool = False):
        self.loop = loop
        self.cost = cost
        self.src = src
        self.dst = dst
        self.hops = hops
        self.qos = qos
        self.busy_until = 0.0        # BULK (and, qos off, only) cursor
        self.lat_busy_until = 0.0    # LATENCY-class cursor (qos only)
        self.last_user: Optional[Hashable] = None  # stream key
        self.stats = LinkStats()

    # ---------------------------------------------------------------- state
    @property
    def name(self) -> str:
        return f"{self.src}->{self.dst}"

    @property
    def latency_us(self) -> float:
        """Propagation latency charged per traversal of this link."""
        return self.hops * self.cost.hop_latency_us

    @property
    def drained(self) -> bool:
        """No reservation extends past *now*: the wire is idle."""
        now = self.loop.now
        return self.busy_until <= now and self.lat_busy_until <= now

    def utilization(self, elapsed_us: float) -> float:
        return self.stats.busy_us / elapsed_us if elapsed_us > 0 else 0.0

    # ------------------------------------------------------------- reserve
    def reserve(self, wire_us: float, earliest: float,
                latency_class: bool = False) -> tuple[float, float]:
        """Book ``wire_us`` of serialization no earlier than ``earliest``.

        Returns ``(start, end)``.  LATENCY-class reservations (qos links
        only) queue behind LATENCY traffic alone and push the BULK
        backlog back by the wire time they steal.
        """
        # (hot path: one call per page per hop of a routed stream — locals
        # bound once, the drained check inlined instead of the property)
        now = self.loop.now
        st = self.stats
        if self.busy_until <= now and self.lat_busy_until <= now:
            # the wire went idle since the previous reservation: whatever
            # streamed last finished long ago and must not be mistaken
            # for a live interleaving stream by the next data packet
            self.last_user = None
        floor = earliest if earliest > now else now
        if latency_class and self.qos:
            start = max(floor, self.lat_busy_until)
            end = start + wire_us
            self.lat_busy_until = end
            if self.busy_until > start:          # jumped a BULK backlog
                if wire_us > 0:
                    st.latency_overtakes += 1
                self.busy_until += wire_us       # stolen wire time
            else:
                self.busy_until = end
        else:
            start = max(floor, self.busy_until,
                        self.lat_busy_until if self.qos else 0.0)
            end = start + wire_us
            self.busy_until = end
        waited = start - floor
        if waited > 0:
            st.queued += 1
            st.queue_us += waited
            if waited > st.max_queue_us:
                st.max_queue_us = waited
        st.busy_us += wire_us
        return start, end

    # ----------------------------------------------------------- data path
    def stream_page(self, nbytes: int, block_key: Hashable, earliest: float,
                    latency_class: bool = False) -> tuple[float, bool]:
        """Serialize one page worth of packets of stream ``block_key``.

        Returns ``(end_time, interleaved_with_another_live_stream)``.
        """
        # a stream that finished long ago cannot interleave with us: the
        # drained check (mirrored inside reserve for control bookings)
        # forgets it before the comparison
        now = self.loop.now
        live = self.busy_until > now or self.lat_busy_until > now
        lu = self.last_user
        interleaved = live and lu is not None and lu != block_key
        _, end = self.reserve(self.cost.packet_wire_us(nbytes), earliest,
                              latency_class=latency_class)
        self.last_user = block_key
        st = self.stats
        st.data_packets += 1
        st.data_bytes += nbytes
        if interleaved:
            st.interleaves += 1
        return end, interleaved

    # -------------------------------------------------------- control path
    def send_ctrl(self, nbytes: int, earliest: float,
                  latency_class: bool = True) -> float:
        """Carry one control message (ACK/NACK/RAPF/request) across.

        Returns the time the message clears this link's wire.  On qos
        links control messages book wire time (and so contend — with
        LATENCY priority by default); on legacy links they charge
        serialization + distance without booking, preserving the seed's
        dedicated-link timing bit-for-bit.
        """
        wire_us = self.cost.packet_wire_us(nbytes) if nbytes > 0 else 0.0
        self.stats.ctrl_packets += 1
        if self.qos:
            _, end = self.reserve(wire_us, earliest,
                                  latency_class=latency_class)
            return end
        return max(self.loop.now, earliest) + wire_us


class Path:
    """The routed chain of directed links between two nodes.

    Reservations chain: a packet cannot start serializing on hop *i+1*
    before it cleared hop *i* (virtual cut-through at page granularity),
    so congestion on any shared link along the route delays the packet
    and everything queued behind it.
    """

    __slots__ = ("loop", "cost", "route", "links", "n_hops", "ledger",
                 "_ledger_rec", "latency_us", "_wire_div")

    def __init__(self, loop: EventLoop, cost: CostModel,
                 route: tuple[int, ...], links: tuple[Link, ...],
                 ledger: Optional[dict] = None):
        self.loop = loop
        self.cost = cost
        self.route = route
        self.links = links
        #: propagation distance: the sum of per-link hop charges (equals
        #: len(links) on physical topologies; the legacy ALL_TO_ALL alias
        #: scales its single direct link instead)
        self.n_hops = sum(l.hops for l in links)
        self.ledger = ledger            # (src, dst) -> [data, ctrl] counts
        self._ledger_rec = None         # this path's entry, bound lazily
        #: routed propagation charge, precomputed once per path — the
        #: per-packet hot path reads a slot instead of multiplying (the
        #: operands are both route/cost constants, so this is bit-exact)
        self.latency_us = self.n_hops * cost.hop_latency_us
        #: CostModel.packet_wire_us inlined: ``(nbytes * 8) / _wire_div``
        #: is the identical expression with the divisor hoisted
        self._wire_div = cost.link_gbps * 1e3

    @property
    def src(self) -> int:
        return self.route[0]

    @property
    def dst(self) -> int:
        return self.route[-1]

    def stream_page(self, nbytes: int, block_key: Hashable,
                    latency_class: bool = False) -> tuple[float, bool]:
        """Reserve wire time on every link along the route for one page.

        Returns ``(arrival_delay_from_now, interleaved)`` — the same
        contract the seed's single :class:`Link` offered the PLDMA model.
        """
        now = self.loop.now
        wire_us = (nbytes * 8) / self._wire_div   # CostModel.packet_wire_us
        t = now
        interleaved = False
        for link in self.links:
            # Inlined Link.stream_page + Link.reserve — the call pair per
            # page per hop (and the per-hop packet_wire_us recompute of a
            # route-constant value) was measurable at million-block scale.
            # Bit-identical to the Link methods, which remain the single-
            # link API for control paths and tests.
            st = link.stats
            bb = link.busy_until
            lb = link.lat_busy_until
            if bb > now or lb > now:
                lu = link.last_user
                if lu is not None and lu != block_key:
                    interleaved = True
                    st.interleaves += 1
            else:
                # drained: a stream that finished long ago must not flag
                # this one as interleaved (same hygiene as Link.reserve)
                link.last_user = None
            floor = t if t > now else now
            if latency_class and link.qos:
                start = floor if floor > lb else lb
                end = start + wire_us
                link.lat_busy_until = end
                if bb > start:                   # jumped a BULK backlog
                    if wire_us > 0:
                        st.latency_overtakes += 1
                    link.busy_until = bb + wire_us   # stolen wire time
                else:
                    link.busy_until = end
            else:
                start = floor
                if bb > start:
                    start = bb
                if link.qos and lb > start:
                    start = lb
                end = start + wire_us
                link.busy_until = end
            waited = start - floor
            if waited > 0:
                st.queued += 1
                st.queue_us += waited
                if waited > st.max_queue_us:
                    st.max_queue_us = waited
            st.busy_us += wire_us
            link.last_user = block_key
            st.data_packets += 1
            st.data_bytes += nbytes
            t = end
        if self.ledger is not None:
            self._ledger()[0] += 1
        return (t - now) + self.latency_us, interleaved

    def send_ctrl(self, nbytes: int = 0,
                  latency_class: bool = True) -> float:
        """Carry one control message along the route.

        Returns the delay from *now* until delivery: per-link wire /
        queueing plus the full routed propagation distance — the ISSUE-4
        control-packet distance-accounting fix (the seed charged a single
        ``hop_latency_us`` however far apart the nodes were).
        """
        now = self.loop.now
        wire_us = (nbytes * 8) / self._wire_div if nbytes > 0 else 0.0
        t = now
        for link in self.links:
            # Inlined Link.send_ctrl + Link.reserve — every ACK/NACK/RAPF
            # books per hop on the same hot path as data pages.
            st = link.stats
            st.ctrl_packets += 1
            if not link.qos:
                # legacy links never book: serialization + distance only
                t = (now if now > t else t) + wire_us
                continue
            bb = link.busy_until
            lb = link.lat_busy_until
            if bb <= now and lb <= now:
                link.last_user = None            # drained-wire hygiene
            floor = t if t > now else now
            if latency_class:
                start = floor if floor > lb else lb
                end = start + wire_us
                link.lat_busy_until = end
                if bb > start:                   # jumped a BULK backlog
                    if wire_us > 0:
                        st.latency_overtakes += 1
                    link.busy_until = bb + wire_us   # stolen wire time
                else:
                    link.busy_until = end
            else:
                start = floor
                if bb > start:
                    start = bb
                if lb > start:
                    start = lb
                end = start + wire_us
                link.busy_until = end
            waited = start - floor
            if waited > 0:
                st.queued += 1
                st.queue_us += waited
                if waited > st.max_queue_us:
                    st.max_queue_us = waited
            st.busy_us += wire_us
            t = end
        if self.ledger is not None:
            self._ledger()[1] += 1
        return (t - now) + self.latency_us

    def _ledger(self) -> list:
        """This path's ``[data, ctrl]`` ledger record (bound on first use
        — a dict probe per packet is measurable on million-block soaks).

        Keyed by the concrete route tuple, not (src, dst): two paths for
        the same endpoints before and after a link failure account their
        packets against the links each actually traversed, which is what
        keeps link-ledger conservation exact across down/up cycles.
        """
        rec = self._ledger_rec
        if rec is None:
            rec = self._ledger_rec = self.ledger.setdefault(
                self.route, [0, 0])
        return rec
