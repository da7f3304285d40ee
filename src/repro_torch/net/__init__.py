"""Topology-aware interconnect for the deterministic fabric simulator.

The seed modelled the network as a dedicated all-to-all :class:`Link`
per node pair with a flat ``hops`` scalar — no link was ever shared, so
cross-tenant traffic never contended and control packets could (and did,
buggily) charge a single hop regardless of distance.  This package
replaces that with a real interconnect:

* :mod:`repro_torch.net.topology` — physical adjacency (ALL_TO_ALL, RING,
  MESH_2D, TORUS_2D matching the QFDB quad layout, DRAGONFLY);
* :mod:`repro_torch.net.router` — deterministic minimal dimension-order
  routing, memoized;
* :mod:`repro_torch.net.link` — per-direction wire reservation with
  LATENCY-over-BULK arbitration and per-link telemetry;
* :mod:`repro_torch.net.interconnect` — the shared fabric object nodes
  transmit through (data pages AND control packets), with the packet
  conservation ledger and :class:`FabricStats` rollup.

Select a topology through :class:`repro_torch.api.FabricConfig`::

    FabricConfig(n_nodes=8, topology="torus_2d", dims=(2, 4))
    FabricConfig(n_nodes=2, hops=4)      # legacy ALL_TO_ALL alias
"""

from repro_torch.net.interconnect import FabricStats, Interconnect
from repro_torch.net.link import Link, LinkStats, Path
from repro_torch.net.router import NetworkPartitioned, Router, RoutingError
from repro_torch.net.topology import (AllToAll, Dragonfly, Mesh2D, Ring, Topology,
                                TopologyError, TopologyKind, Torus2D,
                                build_topology)

__all__ = [
    "AllToAll", "Dragonfly", "FabricStats", "Interconnect", "Link",
    "LinkStats", "Mesh2D", "NetworkPartitioned", "Path", "Ring", "Router",
    "RoutingError", "Topology", "TopologyError", "TopologyKind", "Torus2D",
    "build_topology",
]
