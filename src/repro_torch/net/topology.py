"""Interconnect topologies for the deterministic fabric simulator.

The thesis evaluates its page-fault mechanism on the ExaNeSt prototype,
whose QFDBs (Quad FPGA Daughter Boards) wire four FPGAs into a quad and
quads into a larger multi-hop fabric over 10 Gb/s HSS links
(§ experimental setup).  The seed simulator collapsed all of that into a
single uniform ``hops`` scalar on dedicated all-to-all links; this module
models the physical adjacency explicitly so that routed traffic from
different tenants can *share* (and contend for) links.

A :class:`Topology` answers exactly two questions:

* ``neighbors(node)`` — which nodes share a physical link with ``node``;
* ``coords(node)`` — where the node sits in the topology's coordinate
  system (used by dimension-order routing).

Provided kinds:

* ``ALL_TO_ALL`` — a dedicated link between every pair (the seed's
  behavior; ``FabricConfig.hops`` scales every link's latency; with
  ``n_nodes=4`` this is one QFDB quad — its four FPGAs are fully
  connected);
* ``RING`` — 1-D torus;
* ``MESH_2D`` — rows × cols grid without wraparound;
* ``TORUS_2D`` — rows × cols grid with wraparound (how quads tile into
  the larger ExaNeSt fabric; note a 2×2 torus is NOT fully connected —
  diagonal pairs are two hops apart);
* ``DRAGONFLY`` — ``(n_groups, group_size)``: all-to-all inside a group
  (each group a quad-like clique), one global link between every pair
  of groups.
"""

from __future__ import annotations

import enum
import math
from typing import Optional, Union


class TopologyKind(enum.Enum):
    ALL_TO_ALL = "all_to_all"
    RING = "ring"
    MESH_2D = "mesh_2d"
    TORUS_2D = "torus_2d"
    DRAGONFLY = "dragonfly"


class TopologyError(ValueError):
    """Invalid topology specification (dims mismatch, too few nodes, ...)."""


class Topology:
    """Physical adjacency of the fabric (undirected; links are built
    per-direction by the :class:`~repro_torch.net.interconnect.Interconnect`)."""

    kind: TopologyKind

    def __init__(self, n_nodes: int, dims: tuple[int, ...]):
        if n_nodes < 1:
            raise TopologyError(f"need at least one node, got {n_nodes}")
        self.n_nodes = n_nodes
        self.dims = dims

    # -- interface --------------------------------------------------------
    def neighbors(self, node: int) -> tuple[int, ...]:
        raise NotImplementedError

    def coords(self, node: int) -> tuple[int, ...]:
        """Coordinates of ``node`` (1-D for rings, (row, col) for grids)."""
        return (node,)

    # -- helpers ----------------------------------------------------------
    def edges(self) -> list[tuple[int, int]]:
        """Every directed physical adjacency, deterministically ordered."""
        out = []
        for u in range(self.n_nodes):
            for v in self.neighbors(u):
                out.append((u, v))
        return out

    def _check_node(self, node: int) -> None:
        if not 0 <= node < self.n_nodes:
            raise TopologyError(
                f"node {node} outside [0, {self.n_nodes})")

    def __repr__(self) -> str:
        return (f"{type(self).__name__}(n_nodes={self.n_nodes}, "
                f"dims={self.dims})")


class AllToAll(Topology):
    kind = TopologyKind.ALL_TO_ALL

    def __init__(self, n_nodes: int, dims: Optional[tuple[int, ...]] = None):
        super().__init__(n_nodes, dims or (n_nodes,))

    def neighbors(self, node: int) -> tuple[int, ...]:
        self._check_node(node)
        return tuple(v for v in range(self.n_nodes) if v != node)


class Ring(Topology):
    kind = TopologyKind.RING

    def __init__(self, n_nodes: int, dims: Optional[tuple[int, ...]] = None):
        dims = dims or (n_nodes,)
        if dims != (n_nodes,):
            raise TopologyError(
                f"RING dims {dims} must be ({n_nodes},)")
        super().__init__(n_nodes, dims)

    def neighbors(self, node: int) -> tuple[int, ...]:
        self._check_node(node)
        n = self.n_nodes
        if n == 1:
            return ()
        return tuple(sorted({(node - 1) % n, (node + 1) % n}))


class Mesh2D(Topology):
    kind = TopologyKind.MESH_2D
    wrap = False

    def __init__(self, n_nodes: int, dims: Optional[tuple[int, ...]] = None):
        dims = dims or _square_dims(n_nodes)
        if len(dims) != 2 or dims[0] * dims[1] != n_nodes:
            raise TopologyError(
                f"{self.kind.value} dims {dims} do not tile {n_nodes} nodes "
                f"(need rows * cols == n_nodes)")
        super().__init__(n_nodes, dims)
        self.rows, self.cols = dims

    def coords(self, node: int) -> tuple[int, int]:
        self._check_node(node)
        return divmod(node, self.cols)

    def node_at(self, r: int, c: int) -> int:
        return r * self.cols + c

    def neighbors(self, node: int) -> tuple[int, ...]:
        r, c = self.coords(node)
        out = set()
        for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            nr, nc = r + dr, c + dc
            if self.wrap:
                nr, nc = nr % self.rows, nc % self.cols
            elif not (0 <= nr < self.rows and 0 <= nc < self.cols):
                continue
            if (nr, nc) != (r, c):
                out.add(self.node_at(nr, nc))
        return tuple(sorted(out))


class Torus2D(Mesh2D):
    kind = TopologyKind.TORUS_2D
    wrap = True


class Dragonfly(Topology):
    """``dims = (n_groups, group_size)``: complete graph inside each group,
    one global link between every pair of groups.

    The global link between groups ``a < b`` lands on member
    ``(b - 1) % group_size`` of group ``a`` and member ``a % group_size``
    of group ``b`` — a fixed, deterministic palmtree arrangement.
    """

    kind = TopologyKind.DRAGONFLY

    def __init__(self, n_nodes: int, dims: Optional[tuple[int, ...]] = None):
        if dims is None:
            g = max(2, int(round(math.sqrt(n_nodes))))
            while n_nodes % g:
                g -= 1
            dims = (g, n_nodes // g)
        if len(dims) != 2 or dims[0] * dims[1] != n_nodes:
            raise TopologyError(
                f"dragonfly dims {dims} do not tile {n_nodes} nodes "
                f"(need n_groups * group_size == n_nodes)")
        if dims[0] < 1 or dims[1] < 1:
            raise TopologyError(f"dragonfly dims {dims} must be positive")
        super().__init__(n_nodes, dims)
        self.n_groups, self.group_size = dims

    def coords(self, node: int) -> tuple[int, int]:
        self._check_node(node)
        return divmod(node, self.group_size)

    def node_at(self, group: int, member: int) -> int:
        return group * self.group_size + member

    def gateway(self, src_group: int, dst_group: int) -> int:
        """The member of ``src_group`` holding the global link toward
        ``dst_group``."""
        if src_group < dst_group:
            member = (dst_group - 1) % self.group_size
        else:
            member = dst_group % self.group_size
        return self.node_at(src_group, member)

    def neighbors(self, node: int) -> tuple[int, ...]:
        g, m = self.coords(node)
        out = {self.node_at(g, j) for j in range(self.group_size) if j != m}
        for other in range(self.n_groups):
            if other == g:
                continue
            if self.gateway(g, other) == node:
                out.add(self.gateway(other, g))
        return tuple(sorted(out))


def _square_dims(n_nodes: int) -> tuple[int, int]:
    """Most-square rows × cols factorization of ``n_nodes``."""
    r = int(math.isqrt(n_nodes))
    while n_nodes % r:
        r -= 1
    return (r, n_nodes // r)


_KINDS: dict[TopologyKind, type] = {
    TopologyKind.ALL_TO_ALL: AllToAll,
    TopologyKind.RING: Ring,
    TopologyKind.MESH_2D: Mesh2D,
    TopologyKind.TORUS_2D: Torus2D,
    TopologyKind.DRAGONFLY: Dragonfly,
}


def coerce_kind(kind: Union[TopologyKind, str]) -> TopologyKind:
    if isinstance(kind, TopologyKind):
        return kind
    try:
        return TopologyKind(str(kind).lower())
    except ValueError:
        raise TopologyError(
            f"unknown topology {kind!r}; choose from "
            f"{sorted(k.value for k in TopologyKind)}") from None


def build_topology(kind: Union[TopologyKind, str], n_nodes: int,
                   dims: Optional[tuple[int, ...]] = None) -> Topology:
    """Instantiate a :class:`Topology` by kind name or enum member."""
    cls = _KINDS[coerce_kind(kind)]
    return cls(n_nodes, tuple(dims) if dims is not None else None)
