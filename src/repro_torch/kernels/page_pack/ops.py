"""Wrappers for page gather / scatter over pools of any page shape.

``pool`` is ``(P, ...)``: pages are flattened to rows of ``E`` elements for
the kernels.  A CUDA tensor goes to the hand-written kernel (or raises —
there is no fallback); a CPU tensor, and only a CPU tensor, takes the plain
version.  ``scatter_pages`` updates ``pool`` **in place** and returns it.
A DTensor raises ``TypeError`` on any device.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import require_local
from repro_torch.kernels.page_pack.page_pack import page_gather, page_scatter
from repro_torch.kernels.page_pack.ref import (page_gather_ref,
                                               page_scatter_ref)


def _flat(pool):
    if not pool.is_contiguous():
        raise ValueError("page pool must be contiguous")
    return pool.view(pool.shape[0], -1)


def gather_pages(pool, indices, out: Optional[torch.Tensor] = None):
    """(P, ...) pool, (n,) indices -> (n, ...) pages."""
    require_local(pool, indices, *(() if out is None else (out,)))
    flat = _flat(pool)
    idx = indices.to(torch.int32)
    shape = (idx.shape[0],) + tuple(pool.shape[1:])
    flat_out = None
    if out is not None:
        if tuple(out.shape) != shape or not out.is_contiguous():
            raise ValueError(f"out must be contiguous with shape {shape}")
        flat_out = out.view(idx.shape[0], -1)
    if pool.device.type == "cpu":
        res = page_gather_ref(flat, idx, flat_out)
    else:
        res = page_gather(flat, idx, flat_out)
    return res.view(shape)


def scatter_pages(pool, indices, block):
    """Write ``block`` (n, ...) into ``pool`` (P, ...) at ``indices``."""
    require_local(pool, indices, block)
    flat = _flat(pool)
    idx = indices.to(torch.int32)
    if not block.is_contiguous():
        raise ValueError("block must be contiguous")
    blk = block.view(block.shape[0], -1)
    if pool.device.type == "cpu":
        page_scatter_ref(flat, idx, blk)
    else:
        page_scatter(flat, idx, blk)
    return pool
