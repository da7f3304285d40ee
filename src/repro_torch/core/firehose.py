"""Firehose registration-cache baseline (Bell & Bonachea, thesis §2.2).

Models the pinning-based strategies the thesis argues against, for the
Fig. 2.3 working-set experiment:

* **PIN_EVERYTHING** — one pin of the whole segment at startup.
* **BOUNCE_BUFFER**  — pinned staging buffers + a copy per transfer.
* **RENDEZVOUS**     — pin/transfer/unpin handshake on every operation.
* **FIREHOSE**       — each node owns F firehoses (pinned remote buckets);
  hits are one-sided and pay nothing; misses move a firehose: round-trip
  synchronization + pin of the new bucket + (deferred) unpin of a victim
  beyond the MAXVICTIM FIFO.

The cliff the paper shows — latency jumping towards Rendezvous once the
working set exceeds M (+MAXVICTIM) — comes out of the hit-rate model here
and is checked in ``benchmarks/fig_2_3_firehose.py``.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque

from repro_torch.core.addresses import PAGE_SIZE
from repro_torch.core.costmodel import CostModel, DEFAULT_COST_MODEL


@dataclasses.dataclass
class FirehoseConfig:
    M_bytes: int = 400 << 20            # pinnable memory for firehoses
    maxvictim_bytes: int = 50 << 20     # deferred-unpin FIFO
    bucket_bytes: int = PAGE_SIZE       # single-page buckets (paper setup)
    n_nodes: int = 2
    rtt_us: float = 4.0                 # put round-trip (calibrated, Fig 4.1)

    @property
    def firehoses_per_node(self) -> int:
        # F = floor(M / (P * (nodes-1)))
        return (self.M_bytes // (self.bucket_bytes
                                 * max(1, self.n_nodes - 1)))


class FirehoseNode:
    """Initiator-side state: which remote buckets our firehoses map."""

    def __init__(self, cfg: FirehoseConfig, cost: CostModel = DEFAULT_COST_MODEL):
        self.cfg = cfg
        self.cost = cost
        self.capacity = cfg.firehoses_per_node
        self.mapped: OrderedDict[int, None] = OrderedDict()  # bucket -> LRU
        self.victim_fifo: deque[int] = deque()
        self.victim_capacity = cfg.maxvictim_bytes // cfg.bucket_bytes
        self.hits = 0
        self.misses = 0
        self.unpins = 0

    def put_latency_us(self, bucket: int, payload_bytes: int = 8) -> float:
        """Latency of an 8-byte put to ``bucket`` on the remote node."""
        base = self.cfg.rtt_us
        if bucket in self.mapped:
            self.mapped.move_to_end(bucket)
            self.hits += 1
            return base
        self.misses += 1
        extra = 0.0
        if len(self.mapped) >= self.capacity:
            old, _ = self.mapped.popitem(last=False)
            self.victim_fifo.append(old)
            if len(self.victim_fifo) > self.victim_capacity:
                # must synchronously unpin a victim bucket remotely
                self.victim_fifo.popleft()
                self.unpins += 1
                extra += self.cost.unpin_us(self.cfg.bucket_bytes)
        self.mapped[bucket] = None
        # round-trip to move the firehose + pin of the new bucket remotely
        extra += self.cfg.rtt_us + self.cost.pin_us(self.cfg.bucket_bytes)
        return base + extra

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 1.0


def rendezvous_put_latency_us(nbytes: int,
                              cost: CostModel = DEFAULT_COST_MODEL,
                              rtt_us: float = 4.0,
                              unpin: bool = True) -> float:
    """Rendezvous: advertise + remote pin, transfer, (optionally) unpin."""
    lat = rtt_us                       # control round-trip
    lat += cost.pin_us(nbytes)         # remote pins the region
    lat += rtt_us                      # the DMA itself (small payload)
    if unpin:
        lat += cost.unpin_us(nbytes)
    return lat


def bounce_buffer_put_latency_us(nbytes: int,
                                 cost: CostModel = DEFAULT_COST_MODEL,
                                 rtt_us: float = 4.0,
                                 copy_gbps: float = 3.0) -> float:
    """Bounce buffers: transfer into pinned staging + remote-side copy."""
    copy_us = nbytes * 8 / (copy_gbps * 1e3)
    interrupt_us = 2.0    # target CPU involvement per put
    return rtt_us + copy_us + interrupt_us
