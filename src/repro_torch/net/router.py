"""Deterministic routing over a :class:`~repro_torch.net.topology.Topology`.

One routing function per topology kind, all minimal and all *oblivious*
(the path depends only on (src, dst), never on load), so a simulation's
event trace stays a pure function of its inputs:

* ALL_TO_ALL — the dedicated direct link;
* RING — the shorter way around, ties broken toward increasing node ids;
* MESH_2D / TORUS_2D — dimension-order (column first, then row); the
  torus picks the shorter wrap direction per dimension, ties broken
  toward positive strides;
* DRAGONFLY — local hop to the source group's gateway, one global hop,
  local hop to the destination.

Routes are returned as node-id tuples ``(src, ..., dst)`` and memoized:
route computation is O(path length) once per (src, dst) pair.
"""

from __future__ import annotations

from collections import deque

from repro_torch.net.topology import (Dragonfly, Mesh2D, Ring, Topology,
                                TopologyKind)


class RoutingError(RuntimeError):
    """The router produced (or was asked for) an impossible path."""


class NetworkPartitioned(RoutingError):
    """No live path exists between two endpoints.

    Raised by :meth:`Router.route_avoiding` (and so by
    ``Interconnect.path`` under link failures) when every physical route
    between ``src`` and ``dst`` crosses a down link — the typed partition
    signal the crash-fault layer turns into
    :attr:`~repro_torch.api.completion.WCStatus.REMOTE_OP_ERR` completions.
    """


class Router:
    """Deterministic minimal router: ``route(src, dst)`` -> hop path."""

    def __init__(self, topology: Topology):
        self.topology = topology
        self._cache: dict[tuple[int, int], tuple[int, ...]] = {}

    def route(self, src: int, dst: int) -> tuple[int, ...]:
        """The node sequence ``(src, n1, ..., dst)`` a packet traverses.

        ``route(n, n)`` is the loopback path ``(n, n)``.
        """
        key = (src, dst)
        path = self._cache.get(key)
        if path is None:
            path = self._compute(src, dst)
            self._verify(path)
            self._cache[key] = path
        return path

    def hops(self, src: int, dst: int) -> int:
        return len(self.route(src, dst)) - 1

    def route_avoiding(self, src: int, dst: int,
                       down: frozenset) -> tuple[int, ...]:
        """A live path ``src -> dst`` that crosses no link in ``down``.

        ``down`` is a set of directed ``(u, v)`` adjacencies that are
        currently failed.  The oblivious minimal route is preferred when
        it is clean (so restoring every link restores bit-exact paths);
        otherwise a deterministic BFS (neighbors expand in sorted order)
        finds a shortest detour.  Raises :class:`NetworkPartitioned`
        when no live path exists.
        """
        path = self.route(src, dst)
        if src == dst or not any(hop in down
                                 for hop in zip(path, path[1:])):
            return path
        # deterministic BFS: first-found shortest path, sorted expansion
        topo = self.topology
        prev: dict[int, int] = {src: src}
        q: deque[int] = deque((src,))
        while q:
            u = q.popleft()
            if u == dst:
                out = [dst]
                while out[-1] != src:
                    out.append(prev[out[-1]])
                out.reverse()
                path = tuple(out)
                self._verify(path)
                return path
            for v in topo.neighbors(u):
                if v not in prev and (u, v) not in down:
                    prev[v] = u
                    q.append(v)
        raise NetworkPartitioned(
            f"no live route {src}->{dst}: every path crosses a down link "
            f"({len(down)} down)")

    # ------------------------------------------------------------ internals
    def _compute(self, src: int, dst: int) -> tuple[int, ...]:
        topo = self.topology
        topo._check_node(src)
        topo._check_node(dst)
        if src == dst:
            return (src, src)
        kind = topo.kind
        if kind is TopologyKind.ALL_TO_ALL:
            return (src, dst)
        if kind is TopologyKind.RING:
            return self._route_ring(src, dst)
        if kind in (TopologyKind.MESH_2D, TopologyKind.TORUS_2D):
            return self._route_grid(src, dst)
        if kind is TopologyKind.DRAGONFLY:
            return self._route_dragonfly(src, dst)
        raise RoutingError(f"no routing function for {kind}")  # pragma: no cover

    def _route_ring(self, src: int, dst: int) -> tuple[int, ...]:
        topo: Ring = self.topology
        n = topo.n_nodes
        fwd = (dst - src) % n
        step = 1 if fwd <= n - fwd else -1
        path = [src]
        while path[-1] != dst:
            path.append((path[-1] + step) % n)
        return tuple(path)

    def _route_grid(self, src: int, dst: int) -> tuple[int, ...]:
        topo: Mesh2D = self.topology
        (sr, sc), (dr, dc) = topo.coords(src), topo.coords(dst)
        path = [src]
        wrap = topo.wrap
        # dimension order: columns (X) first, then rows (Y)
        c = sc
        while c != dc:
            c = (c + self._stride(c, dc, topo.cols, wrap)) % topo.cols
            path.append(topo.node_at(sr, c))
        r = sr
        while r != dr:
            r = (r + self._stride(r, dr, topo.rows, wrap)) % topo.rows
            path.append(topo.node_at(r, dc))
        return tuple(path)

    @staticmethod
    def _stride(cur: int, tgt: int, size: int, wrap: bool) -> int:
        if not wrap:
            return 1 if tgt > cur else -1
        fwd = (tgt - cur) % size
        return 1 if fwd <= size - fwd else -1

    def _route_dragonfly(self, src: int, dst: int) -> tuple[int, ...]:
        topo: Dragonfly = self.topology
        (sg, _), (dg, _) = topo.coords(src), topo.coords(dst)
        if sg == dg:
            return (src, dst)       # intra-group: complete graph
        out_gw = topo.gateway(sg, dg)
        in_gw = topo.gateway(dg, sg)
        path = [src]
        if out_gw != src:
            path.append(out_gw)
        path.append(in_gw)
        if in_gw != dst:
            path.append(dst)
        return tuple(path)

    def _verify(self, path: tuple[int, ...]) -> None:
        """Every consecutive pair must be a physical adjacency (or the
        loopback pair) and no intermediate node may repeat."""
        if len(path) < 2:
            raise RoutingError(f"degenerate path {path}")
        if len(path) == 2 and path[0] == path[1]:
            return                   # loopback
        topo = self.topology
        for u, v in zip(path, path[1:]):
            if v not in topo.neighbors(u):
                raise RoutingError(
                    f"route {path} uses non-adjacent hop {u}->{v} "
                    f"on {topo!r}")
        if len(set(path)) != len(path):
            raise RoutingError(f"route {path} revisits a node")
