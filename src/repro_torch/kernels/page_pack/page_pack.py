"""Bindings of the CUDA page gather / scatter kernels (``csrc/page_pack.cu``).

Counterparts of the reference's Pallas ``page_gather`` / ``page_scatter``:
rows are copied as raw bytes, so any element type is accepted.  CUDA
tensors only; :mod:`.ops` routes CPU tensors to :mod:`.ref`.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels._build import check_launch, load_library


def _check(name: str, pool, indices, block_shape=None, block=None) -> None:
    def require(cond, msg):
        if not cond:
            raise ValueError(f"{name}: {msg}")
    require(pool.is_cuda, "pool must be a CUDA tensor")
    require(pool.dim() == 2 and pool.is_contiguous(),
            "pool must be a contiguous (P, E) tensor")
    require(pool.shape[0] > 0 and pool.shape[1] > 0, "pool is empty")
    require(indices.device == pool.device and indices.dtype == torch.int32
            and indices.dim() == 1 and indices.is_contiguous(),
            "indices must be a contiguous int32 (n,) tensor on the pool's "
            "device")
    if block is not None:
        require(block.device == pool.device and block.dtype == pool.dtype,
                "block must match the pool's device and dtype")
        require(tuple(block.shape) == tuple(block_shape)
                and block.is_contiguous(),
                f"block must be contiguous with shape {tuple(block_shape)}, "
                f"got {tuple(block.shape)}")


def page_gather(pool, indices, out: Optional[torch.Tensor] = None):
    """pool: (P, E); indices: (n,) int32 -> (n, E).  Negative indices clamp
    to row 0.  ``out``, if given, receives the rows (no allocation)."""
    n, E = indices.shape[0], pool.shape[1] if pool.dim() == 2 else 0
    _check("page_gather", pool, indices, (n, E), out)
    if out is None:
        out = torch.empty((n, E), dtype=pool.dtype, device=pool.device)
    if n == 0:
        return out
    lib = load_library()
    with torch.cuda.device(pool.device):
        code = lib.repro_page_gather(
            pool.data_ptr(), indices.data_ptr(), out.data_ptr(),
            E * pool.element_size(), n, pool.shape[0],
            torch.cuda.current_stream(pool.device).cuda_stream)
    check_launch(code, "page_gather")
    LAUNCHES["page_gather"] += 1
    return out


def page_scatter(pool, indices, block):
    """Write ``block`` (n, E) into ``pool`` (P, E) at ``indices``, **in
    place**; rows not named keep their contents.  Negative indices clamp to
    row 0; with duplicate indices the surviving row is undefined.  Returns
    ``pool``."""
    n, E = indices.shape[0], pool.shape[1] if pool.dim() == 2 else 0
    _check("page_scatter", pool, indices, (n, E), block)
    if n == 0:
        return pool
    lib = load_library()
    with torch.cuda.device(pool.device):
        code = lib.repro_page_scatter(
            pool.data_ptr(), indices.data_ptr(), block.data_ptr(),
            E * pool.element_size(), n, pool.shape[0],
            torch.cuda.current_stream(pool.device).cuda_stream)
    check_launch(code, "page_scatter")
    LAUNCHES["page_scatter"] += 1
    return pool
