"""Memory registration: ``MemoryRegion`` handles with owned prep state.

The seed engine passed raw ``(pd, va, nbytes)`` triples around and made
callers track preparation state and prep cost themselves.  Here
``ProtectionDomain.register_memory()`` returns a :class:`MemoryRegion`
that owns both: how the buffer was prepared (faulting / touched / pinned
— the thesis' three comparisons) and the user-side microseconds that
preparation cost (mmap + touch/pin now, unpin + munmap at deregister).

Unlike real verbs, registration does **not** pin by default — that is the
paper's whole point: ``BufferPrep.FAULTING`` regions are valid RDMA
targets whose pages fault in on first access.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import TYPE_CHECKING, Optional

from repro_torch.core.addresses import pages_spanned

if TYPE_CHECKING:                                    # pragma: no cover
    from repro_torch.api.fabric import ProtectionDomain


class BufferPrep(enum.Enum):
    """How a buffer is prepared before the RDMA (the thesis' comparisons)."""
    FAULTING = "faulting"        # mmap'ed only: every page faults on access
    TOUCHED = "touched"          # pre-touched: resident, unpinned
    PINNED = "pinned"            # pinned (and therefore resident)


@dataclasses.dataclass
class PrepCost:
    """User-side microseconds spent preparing / releasing one buffer."""
    mmap_us: float = 0.0
    prep_us: float = 0.0         # touch or pin
    release_us: float = 0.0      # unpin (pin case)
    munmap_us: float = 0.0

    @property
    def total_us(self) -> float:
        return self.mmap_us + self.prep_us + self.release_us + self.munmap_us


class RegionError(RuntimeError):
    """Operation on a deregistered (or otherwise invalid) memory region."""


class MemoryRegion:
    """A registered buffer on one node of one protection domain.

    Carries the verbs-style remote key (``rkey``) plus the prep state and
    cost accounting the thesis measures.  Work requests reference regions,
    not raw addresses — ``post_write(src=mr_a, dst=mr_b)``.
    """

    __slots__ = ("domain", "node_id", "addr", "length", "prep", "prep_cost",
                 "rkey", "registered")

    def __init__(self, domain: "ProtectionDomain", node_id: int, addr: int,
                 length: int, prep: BufferPrep, prep_cost: PrepCost,
                 rkey: int):
        self.domain = domain
        self.node_id = node_id
        self.addr = addr
        self.length = length
        self.prep = prep
        self.prep_cost = prep_cost
        self.rkey = rkey
        self.registered = True

    # ------------------------------------------------------------- queries
    @property
    def pd(self) -> int:
        return self.domain.pd

    @property
    def pages(self) -> list[int]:
        """Virtual page numbers spanned by the region."""
        return pages_spanned(self.addr, self.length)

    def resident_pages(self) -> int:
        pt = self.domain.fabric.nodes[self.node_id].pt(self.pd)
        return sum(1 for vpn in self.pages if pt.is_resident(vpn))

    def contains(self, va: int, nbytes: int) -> bool:
        return self.addr <= va and va + nbytes <= self.addr + self.length

    # ------------------------------------------------------------ teardown
    def deregister(self) -> PrepCost:
        """munmap the region; completes the prep-cost accounting."""
        if not self.registered:
            raise RegionError(f"region rkey={self.rkey} already deregistered")
        fabric = self.domain.fabric
        node = fabric.nodes[self.node_id]
        node.pt(self.pd).munmap(self.addr, self.length)
        self.prep_cost.munmap_us = fabric.cost.munmap_us(self.length)
        self.registered = False
        return self.prep_cost

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"MemoryRegion(pd={self.pd}, node={self.node_id}, "
                f"addr={self.addr:#x}, len={self.length}, "
                f"prep={self.prep.value}, rkey={self.rkey})")
