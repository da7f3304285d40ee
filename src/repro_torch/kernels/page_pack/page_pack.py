"""Bindings of the CUDA page gather / scatter kernels (``csrc/page_pack.cu``).

Counterparts of the reference's Pallas ``page_gather`` / ``page_scatter``:
rows are copied as raw bytes, so any element type is accepted.  CUDA
tensors only; :mod:`.ops` routes CPU tensors to :mod:`.ref`.  A copy of
16-byte aligned rows follows :func:`copy_plan`: bulk copies for large
copies, the word loop for small ones; other rows take the word loop.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels._build import check_launch, load_library, sm_count

WORDS, BULK = 0, 1          # the kernels' two modes (csrc/page_pack.cu)
BULK_MIN_BYTES = 16 << 20   # copies this large take bulk copies
MAX_PIECE = 32768           # bytes: a bulk copy's largest piece
STAGES = 3                  # ring slots a bulk block
BLOCKS_PER_SM = 4           # blocks of the bulk grid a SM


def piece_plan(n: int, row_bytes: int, n_sm: int) -> tuple:
    """``(piece bytes, blocks)`` of a bulk copy of ``n`` rows of
    ``row_bytes``: the fewest pieces a row of at most ``MAX_PIECE`` bytes,
    evened out over the row in multiples of 16 bytes (the last piece of a
    row may be shorter); ``BLOCKS_PER_SM * n_sm`` blocks, or one a piece
    when there are fewer pieces."""
    per_row = -(-row_bytes // MAX_PIECE)
    piece = -(-row_bytes // per_row)
    piece = -(-piece // 16) * 16
    return piece, min(BLOCKS_PER_SM * n_sm, n * per_row)


def copy_plan(n: int, row_bytes: int, n_sm: int) -> tuple:
    """``(mode, piece bytes, blocks, stages)`` of a copy of ``n`` rows of
    ``row_bytes`` (16-byte aligned; the kernels take narrower words for
    other rows whatever the plan).  At least ``BULK_MIN_BYTES`` in all:
    bulk copies as :func:`piece_plan` cuts them, through rings of
    ``STAGES`` slots.  Below that the word loop, which needs no plan (a
    bulk copy's round trip through shared memory costs more than it saves
    there)."""
    if n * row_bytes >= BULK_MIN_BYTES:
        return (BULK,) + piece_plan(n, row_bytes, n_sm) + (STAGES,)
    return WORDS, 0, 0, 0


def _plan(pool, n: int, row_bytes: int) -> tuple:
    index = pool.device.index if pool.device.index is not None \
        else torch.cuda.current_device()
    return copy_plan(n, row_bytes, sm_count(index))


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
    row_bytes = E * pool.element_size()
    plan = _plan(pool, n, row_bytes)
    lib = load_library()
    with torch.cuda.device(pool.device):
        code = lib.repro_page_gather(
            pool.data_ptr(), indices.data_ptr(), out.data_ptr(), row_bytes,
            n, pool.shape[0], *plan,
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
    row_bytes = E * pool.element_size()
    plan = _plan(pool, n, row_bytes)
    lib = load_library()
    with torch.cuda.device(pool.device):
        code = lib.repro_page_scatter(
            pool.data_ptr(), indices.data_ptr(), block.data_ptr(), row_bytes,
            n, pool.shape[0], *plan,
            torch.cuda.current_stream(pool.device).cuda_stream)
    check_launch(code, "page_scatter")
    LAUNCHES["page_scatter"] += 1
    return pool


def empty_launch(blocks: int, device) -> None:
    """One launch of an empty kernel of ``blocks`` one-warp blocks on the
    current stream: the floor under a copy's time, timed the same way.  A
    measurement aid, on no path and not counted."""
    lib = load_library()
    with torch.cuda.device(device):
        code = lib.repro_empty_launch(
            int(blocks), torch.cuda.current_stream(device).cuda_stream)
    check_launch(code, "empty kernel")
