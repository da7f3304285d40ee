"""The routed interconnect: topology + router + per-direction links.

One :class:`Interconnect` is shared by every node of a fabric.  It owns

* a directed :class:`~repro_torch.net.link.Link` per physical adjacency of the
  :class:`~repro_torch.net.topology.Topology` (plus one loopback link per
  node),
* a deterministic :class:`~repro_torch.net.router.Router`,
* memoized :class:`~repro_torch.net.link.Path` objects — the transmit handle a
  node uses for both data pages and control packets,
* the packet-conservation ledger: every path send is recorded per
  concrete *route tuple*, so ``repro_torch.testing`` can prove that each link
  carried exactly the packets of the routes crossing it (nothing lost,
  nothing duplicated, nothing smuggled around the topology) — keyed by
  route, not (src, dst), so the invariant survives re-pathing: packets
  that crossed the old route before a link failure and packets that
  crossed the detour after it are accounted against the links they
  *actually* traversed,
* the machine-failure model: :meth:`Interconnect.fail_link` /
  :meth:`restore_link` / :meth:`fail_node` mark directed adjacencies
  down; :meth:`path` re-routes around them (deterministic BFS detours)
  and raises :class:`~repro_torch.net.router.NetworkPartitioned` when no live
  route remains.

Per-link telemetry rolls up into :class:`FabricStats`.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional, Union

from repro_torch.net.link import Link, LinkStats, Path

if TYPE_CHECKING:                                    # pragma: no cover
    # type-only: repro_torch.net is the bottom layer — importing repro_torch.core at
    # runtime would pull core/__init__ -> engine -> api -> net back in
    from repro_torch.core.costmodel import CostModel
    from repro_torch.core.simulator import EventLoop
from repro_torch.net.router import NetworkPartitioned, Router
from repro_torch.net.topology import (Topology, TopologyKind, build_topology,
                                coerce_kind)


@dataclasses.dataclass
class FabricStats:
    """Fabric-wide interconnect telemetry: per-link stats + totals."""

    links: dict                      # "s->d" -> LinkStats.as_dict()
    data_packets: int = 0
    ctrl_packets: int = 0
    data_bytes: int = 0
    busy_us: float = 0.0
    queued: int = 0
    queue_us: float = 0.0
    max_queue_us: float = 0.0
    latency_overtakes: int = 0
    interleaves: int = 0
    elapsed_us: float = 0.0

    def as_dict(self) -> dict:
        """Deterministic JSON-able form (sorted link keys)."""
        return {
            "totals": {
                "data_packets": self.data_packets,
                "ctrl_packets": self.ctrl_packets,
                "data_bytes": self.data_bytes,
                "busy_us": round(self.busy_us, 6),
                "queued": self.queued,
                "queue_us": round(self.queue_us, 6),
                "max_queue_us": round(self.max_queue_us, 6),
                "latency_overtakes": self.latency_overtakes,
                "interleaves": self.interleaves,
            },
            "links": {k: self.links[k] for k in sorted(self.links)},
        }

    def max_utilization(self) -> float:
        if self.elapsed_us <= 0:
            return 0.0
        return max((v["busy_us"] / self.elapsed_us
                    for v in self.links.values()), default=0.0)


class Interconnect:
    """Topology-aware link fabric shared by all nodes of a simulation."""

    def __init__(self, loop: EventLoop, cost: CostModel,
                 topology: Union[Topology, TopologyKind, str],
                 n_nodes: Optional[int] = None,
                 dims: Optional[tuple[int, ...]] = None,
                 qos: Optional[bool] = None,
                 legacy_hops: int = 1):
        if not isinstance(topology, Topology):
            topology = build_topology(coerce_kind(topology), n_nodes, dims)
        self.loop = loop
        self.cost = cost
        self.topology = topology
        self.router = Router(topology)
        self.legacy_hops = legacy_hops
        #: link QoS (LATENCY overtakes BULK on the wire): defaults to on
        #: for routed topologies, off for the seed's dedicated ALL_TO_ALL
        self.qos = (topology.kind is not TopologyKind.ALL_TO_ALL
                    if qos is None else qos)
        self.links: dict[tuple[int, int], Link] = {}
        for (u, v) in topology.edges():
            hops = (legacy_hops
                    if topology.kind is TopologyKind.ALL_TO_ALL else 1)
            self.links[(u, v)] = Link(loop, cost, u, v, hops=hops,
                                      qos=self.qos)
        for n in range(topology.n_nodes):
            self.links[(n, n)] = Link(loop, cost, n, n, hops=1,
                                      qos=self.qos)
        self._paths: dict[tuple[int, int], Path] = {}
        #: route tuple -> [data_packets, ctrl_packets] injected — the
        #: ledger side of the per-link packet-conservation invariant.
        #: Keyed by the concrete route (not (src, dst)) so conservation
        #: holds across re-pathing: each injection is charged against the
        #: exact links its packets traversed at send time.
        self.injected: dict[tuple[int, ...], list] = {}
        #: directed adjacencies currently failed (both directions of a
        #: physical link go down together via fail_link)
        self.down: frozenset[tuple[int, int]] = frozenset()
        #: failure-epoch path memo, cleared on every fail/restore
        self._detour_paths: dict[tuple[int, int], Path] = {}

    # ---------------------------------------------------------------- paths
    def path(self, src: int, dst: int) -> Path:
        """The (memoized) routed path ``src -> dst``.

        With links down, routes detour deterministically around them;
        raises :class:`~repro_torch.net.router.NetworkPartitioned` when no
        live route exists.  With no failures this is exactly the
        oblivious minimal route (bit-exact with the no-crash fabric).
        """
        key = (src, dst)
        if not self.down:
            p = self._paths.get(key)
            if p is None:
                p = self._make_path(self.router.route(src, dst))
                self._paths[key] = p
            return p
        p = self._detour_paths.get(key)
        if p is None:
            route = self.router.route_avoiding(src, dst, self.down)
            base = self._paths.get(key)
            if base is not None and base.route == route:
                p = base                 # clean oblivious route: reuse
            else:
                p = self._make_path(route)
            self._detour_paths[key] = p
        return p

    def _make_path(self, route: tuple[int, ...]) -> Path:
        src, dst = route[0], route[-1]
        if src == dst:
            links = (self.links[(src, src)],)
        else:
            links = tuple(self.links[(u, v)]
                          for u, v in zip(route, route[1:]))
        return Path(self.loop, self.cost, route, links,
                    ledger=self.injected)

    def link(self, src: int, dst: int) -> Link:
        """The directed link of a physical adjacency (or loopback)."""
        return self.links[(src, dst)]

    # -------------------------------------------------------------- failures
    def fail_link(self, u: int, v: int) -> None:
        """Take the physical adjacency ``u <-> v`` down (both directions).

        Future :meth:`path` lookups re-route around it; reservations
        already booked on the wire complete (a failing link does not
        destroy packets mid-flight — endpoint crash handling decides
        what a delivered packet means to a dead node).
        """
        if (u, v) not in self.links or u == v:
            raise KeyError(f"no physical adjacency {u}<->{v}")
        self.down = self.down | {(u, v), (v, u)}
        self._detour_paths.clear()

    def restore_link(self, u: int, v: int) -> None:
        """Bring the physical adjacency ``u <-> v`` back up."""
        if (u, v) not in self.links or u == v:
            raise KeyError(f"no physical adjacency {u}<->{v}")
        self.down = self.down - {(u, v), (v, u)}
        self._detour_paths.clear()

    def fail_node(self, n: int) -> None:
        """Take every physical adjacency incident to node ``n`` down."""
        self.topology._check_node(n)
        incident = {(u, v) for (u, v) in self.links
                    if u != v and (u == n or v == n)}
        self.down = self.down | incident
        self._detour_paths.clear()

    def reachable(self, src: int, dst: int) -> bool:
        """True iff a live route ``src -> dst`` exists right now."""
        try:
            self.router.route_avoiding(src, dst, self.down)
            return True
        except NetworkPartitioned:
            return False

    # ---------------------------------------------------------------- stats
    def stats(self) -> FabricStats:
        out = FabricStats(links={}, elapsed_us=self.loop.now)
        for (u, v), link in sorted(self.links.items()):
            s = link.stats
            if not (s.data_packets or s.ctrl_packets):
                continue                       # quiet links stay out
            out.links[link.name] = s.as_dict()
            for f in LinkStats.ADDITIVE:
                setattr(out, f, getattr(out, f) + getattr(s, f))
            out.max_queue_us = max(out.max_queue_us, s.max_queue_us)
        out.busy_us = round(out.busy_us, 6)
        out.queue_us = round(out.queue_us, 6)
        out.max_queue_us = round(out.max_queue_us, 6)
        return out

    # ----------------------------------------------------------- invariants
    def conservation_violations(self) -> list[str]:
        """Per-link packet conservation against the injection ledger.

        The ledger is keyed by the concrete route tuple each packet was
        sent along, so the expected per-link counts are a pure fold over
        the ledger — no route recomputation, which is what keeps the
        invariant meaningful across link failures and re-pathing (a
        post-failure recompute would charge pre-failure packets to the
        detour they never took).
        """
        expect_data: dict[tuple[int, int], int] = {}
        expect_ctrl: dict[tuple[int, int], int] = {}
        # torch-lint: allow(det-dict-iter): commutative += accumulation
        for route, (n_data, n_ctrl) in self.injected.items():
            for hop in zip(route, route[1:]):
                expect_data[hop] = expect_data.get(hop, 0) + n_data
                expect_ctrl[hop] = expect_ctrl.get(hop, 0) + n_ctrl
        out = []
        for key, link in sorted(self.links.items()):
            want_d = expect_data.get(key, 0)
            want_c = expect_ctrl.get(key, 0)
            if link.stats.data_packets != want_d:
                out.append(
                    f"link {link.name}: carried {link.stats.data_packets} "
                    f"data packets, routes injected {want_d}")
            if link.stats.ctrl_packets != want_c:
                out.append(
                    f"link {link.name}: carried {link.stats.ctrl_packets} "
                    f"ctrl packets, routes injected {want_c}")
        return out
