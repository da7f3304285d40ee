"""Control-plane leaf modules the serving path needs (addresses, cost
model, page table, resolver strategies, arbiter service classes).

Only what the ported slice uses is exported; the node, fabric and
simulator modules of the reference's ``core`` are not ported yet.
"""

from repro_torch.core.addresses import (BLOCK_SIZE, MTU, PAGE_SIZE,
                                        PAGES_PER_BLOCK)
from repro_torch.core.arbiter import ServiceClass
from repro_torch.core.costmodel import CostModel, DEFAULT_COST_MODEL
from repro_torch.core.pagetable import (FrameAllocator, PageState, PageTable,
                                        SegmentationFault)
from repro_torch.core.resolver import Resolution, Resolver, Strategy

__all__ = [
    "BLOCK_SIZE", "MTU", "PAGE_SIZE", "PAGES_PER_BLOCK", "ServiceClass",
    "CostModel", "DEFAULT_COST_MODEL", "FrameAllocator", "PageState",
    "PageTable", "SegmentationFault", "Resolution", "Resolver", "Strategy",
]
