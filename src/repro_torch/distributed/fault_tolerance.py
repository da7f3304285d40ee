"""Cluster-level fault tolerance: heartbeats, stragglers, elastic rescale.

Control-plane components (pure Python, virtual-clock testable) that a
1000-node deployment wires to its coordinator:

* :class:`HeartbeatMonitor` — per-node liveness with configurable timeout;
  the same timeout-as-backstop philosophy as the thesis' R5 (an explicit
  failure NACK is faster, the timeout catches silent deaths).
* :class:`StragglerDetector` — per-step duration EWMA + deviation; flags
  nodes whose step times exceed median × threshold so the scheduler can
  rebalance or evict (mirrors the thesis Fig 4.6 insight: explicit early
  signals beat waiting for the worst-case timeout).
* :class:`ElasticPlan` — given dead nodes, pick the largest valid
  (pod, data, model) sub-mesh, keeping 'model' intact (TP groups die with
  any member) and shrinking 'data' — then the checkpointer's elastic
  restore re-slices state for the survivor mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class NodeState:
    last_seen: float = 0.0
    alive: bool = True
    step_ewma: float = 0.0
    steps: int = 0


class HeartbeatMonitor:
    def __init__(self, n_nodes: int, timeout: float = 30.0):
        self.timeout = timeout
        self.nodes = {i: NodeState() for i in range(n_nodes)}

    def beat(self, node: int, now: float) -> None:
        st = self.nodes[node]
        st.last_seen = now
        st.alive = True

    def check(self, now: float) -> list[int]:
        """Returns newly-dead node ids."""
        dead = []
        for i, st in self.nodes.items():
            if st.alive and now - st.last_seen > self.timeout:
                st.alive = False
                dead.append(i)
        return dead

    @property
    def alive_nodes(self) -> list[int]:
        return [i for i, st in self.nodes.items() if st.alive]


class StragglerDetector:
    """Flag nodes whose step time exceeds median × threshold."""

    def __init__(self, n_nodes: int, alpha: float = 0.3,
                 threshold: float = 1.5, min_steps: int = 3):
        self.alpha = alpha
        self.threshold = threshold
        self.min_steps = min_steps
        self.nodes = {i: NodeState() for i in range(n_nodes)}

    def record(self, node: int, step_time: float) -> None:
        st = self.nodes[node]
        st.step_ewma = (step_time if st.steps == 0
                        else self.alpha * step_time
                        + (1 - self.alpha) * st.step_ewma)
        st.steps += 1

    def stragglers(self) -> list[int]:
        ready = {i: st.step_ewma for i, st in self.nodes.items()
                 if st.steps >= self.min_steps}
        if len(ready) < 2:
            return []
        med = float(np.median(list(ready.values())))
        return [i for i, t in ready.items() if t > self.threshold * med]


@dataclasses.dataclass
class ElasticPlan:
    """New mesh after failures + the data-reshard description."""
    old_shape: tuple
    new_shape: tuple
    surviving_hosts: list
    reshard_data_factor: float     # old_data_size / new_data_size

    @property
    def viable(self) -> bool:
        return all(s >= 1 for s in self.new_shape)


def plan_rescale(mesh_shape: dict, dead_nodes: list[int],
                 nodes_per_host: int = 4) -> ElasticPlan:
    """Shrink the data axis to exclude hosts containing dead nodes.

    Mesh axes: optional 'pod', 'data', 'model'.  'model' (TP) groups
    cannot lose members, so a dead node kills its whole data slice; we
    drop that slice and keep the largest surviving data extent.
    """
    data = mesh_shape.get("data", 1)
    model = mesh_shape.get("model", 1)
    pod = mesh_shape.get("pod", 1)
    total_nodes = pod * data * model
    hosts = {n // nodes_per_host for n in dead_nodes}
    # each data slice spans `model` consecutive nodes (row-major mesh)
    dead_slices = set()
    for n in dead_nodes:
        flat = n
        slice_idx = flat // model          # (pod*data) index
        dead_slices.add(slice_idx)
    surviving = [s for s in range(pod * data) if s not in dead_slices]
    new_data = len(surviving)
    # keep 'pod' if both pods retain equal slices, else fold into data
    old = tuple(v for v in (pod, data, model) if v)
    if pod > 1:
        per_pod = [len([s for s in surviving if s // data == p])
                   for p in range(pod)]
        if len(set(per_pod)) == 1 and per_pod[0] > 0:
            new_shape = (pod, per_pod[0], model)
        else:
            new_shape = (1, new_data, model)
    else:
        new_shape = (new_data, model)
    return ElasticPlan(old_shape=(pod, data, model) if pod > 1
                       else (data, model),
                       new_shape=new_shape,
                       surviving_hosts=sorted(
                           {s for s in surviving}),
                       reshard_data_factor=(pod * data) / max(1, new_data))
