"""Plain PyTorch versions of page gather / scatter (indexing)."""

from __future__ import annotations

from typing import Optional

import torch


def page_gather_ref(pool, indices, out: Optional[torch.Tensor] = None):
    rows = pool[indices.clamp(min=0).long()]
    if out is None:
        return rows
    out.copy_(rows)
    return out


def page_scatter_ref(pool, indices, block):
    """In place, like the kernel; returns ``pool``."""
    pool[indices.clamp(min=0).long()] = block
    return pool
