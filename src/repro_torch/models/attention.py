"""GQA attention layer: projections + RoPE + qk-norm + SWA + paged decode.

Training / prefill attention (:func:`apply_attention`) calls the
hand-written flash-attention kernels through
``kernels.flash_attention.ops.flash_attention``; the paged decode path calls
the hand-written kernel through ``kernels.paged_attention.ops.paged_attention``,
on the whole batch or, under a data-parallel mesh, on each rank's shard
(:func:`_paged_update_and_attend_dist`).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed import logical
from repro_torch.distributed.logical import PartitionSpec as P, constrain
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.models.attention_ops import ring_buffer_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_rope, dense_init, rms_head_norm,
                                       rope_tables)


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype):
    d, H, KVH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dev = gen.device
    p = {
        "wq": dense_init(gen, d, H * hd, dtype),
        "wk": dense_init(gen, d, KVH * hd, dtype),
        "wv": dense_init(gen, d, KVH * hd, dtype),
        "wo": dense_init(gen, H * hd, d, dtype),
    }
    if cfg.attn_bias:
        p["bq"] = torch.zeros((H * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((KVH * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((KVH * hd,), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=torch.float32, device=dev)
        p["k_norm"] = torch.ones((hd,), dtype=torch.float32, device=dev)
    return p


def _qkv(p, cfg: ModelConfig, x, positions, rope=None):
    """``rope``: precomputed ``rope_tables`` for ``positions`` (made here
    when absent)."""
    B, S, _ = x.shape
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KVH, hd)
    v = v.reshape(B, S, KVH, hd)
    if cfg.qk_norm:
        q = rms_head_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_head_norm(p["k_norm"], k, cfg.norm_eps)
    if rope is None:
        rope = rope_tables(positions, hd, cfg.rope_theta)
    q = apply_rope(q, positions, cfg.rope_theta, rope)
    k = apply_rope(k, positions, cfg.rope_theta, rope)
    q = constrain(q, "batch", "q_seq", "heads", "head_dim")
    k = constrain(k, "batch", "kv_seq", "kv_heads", "head_dim")
    v = constrain(v, "batch", "kv_seq", "kv_heads", "head_dim")
    return q, k, v


def apply_attention(p, cfg: ModelConfig, x, positions, *,
                    q_chunk: int = 512, kv_chunk: int = 512,
                    return_kv: bool = False, causal: bool = True, rope=None):
    """Training / prefill attention (causal, optionally sliding-window).

    ``rope``: precomputed ``rope_tables`` for ``positions`` (shared by all
    layers of a forward; made here when absent)."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions, rope)
    out = flash_attention(q, k, v, causal=causal,
                          window=cfg.sliding_window if causal else 0,
                          q_chunk=q_chunk, kv_chunk=kv_chunk)
    out = constrain(out, "batch", "q_seq", "heads", "head_dim")
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim) @ p["wo"]
    out = constrain(out, "batch", "seq", "embed")
    if return_kv:
        return out, (k, v)
    return out


def paged_write_slots(page_table, lengths, ps: int):
    """(frame, offset) index tensors, each (B,), of the pool rows that take
    the new token's K/V.  As in the reference, the whole batch writes at
    the page offset of row 0 (``offset[0]``): decode steps are in lockstep.
    The same for every layer of a step, so ``decode_step`` makes them once.
    """
    pos = lengths - 1
    page_slot = torch.div(pos, ps, rounding_mode="floor")
    offset = pos - page_slot * ps
    frame = torch.gather(page_table, 1, page_slot[:, None].long())[:, 0]
    frame = frame.clamp(min=0).long()
    return frame, offset[:1].long().expand(frame.shape[0])


def _paged_update_and_attend(q1, k1, v1, k_pool, v_pool, page_table,
                             lengths, window: int, slots=None):
    """Write the new token's K/V into its page, then attend.

    The pools are updated **in place** (and returned).  ``slots``:
    precomputed :func:`paged_write_slots` (made here when absent).
    """
    if slots is None:
        slots = paged_write_slots(page_table, lengths, k_pool.shape[1])
    k_pool.index_put_(slots, k1)
    v_pool.index_put_(slots, v1)
    out = paged_attention(q1, k_pool, v_pool, page_table, lengths,
                          window=window)
    return out, k_pool, v_pool


def data_shards(batch: int, pages: int):
    """(mesh, data axes, data size) of the active logical rules when the
    batch rows and the pool pages split evenly over the data axes, else
    None: no mesh, no ``"batch"`` rule, one data shard, ``batch % d`` or
    ``pages % d`` (the reference's conditions, in its order)."""
    mesh = logical.current_mesh()
    daxes = logical.rule("batch")
    if mesh is None or daxes is None:
        return None
    sizes = logical.mesh_shape(mesh)
    axes = daxes if isinstance(daxes, tuple) else (daxes,)
    dsize = int(np.prod([sizes[a] for a in axes]))
    if dsize <= 1 or batch % dsize or pages % dsize:
        return None
    return mesh, daxes, dsize


def data_rank(mesh, daxes) -> int:
    """This rank's row-major coordinate over the data axes, in the mesh's
    order: the shard of a dim that DTensor splits over them."""
    axes = daxes if isinstance(daxes, tuple) else (daxes,)
    sizes = logical.mesh_shape(mesh)
    rank = 0
    for a in mesh.mesh_dim_names:
        if a in axes:
            rank = rank * sizes[a] + mesh.get_local_rank(a)
    return rank


def rebase_page_table(page_table, rank: int, p_local: int):
    """Global frames to the frames of rank ``rank``'s pool slice
    ``[rank * p_local, (rank + 1) * p_local)``; unmapped (< 0) stay."""
    return torch.where(page_table >= 0, page_table - rank * p_local,
                       page_table)


def paged_shard_local(q1, k1, v1, k_pool, v_pool, page_table, lengths,
                      window: int, rank: int, p_local: int):
    """What one data rank runs on its shard: its batch rows, its slice of
    the pool (``p_local`` frames), and the global page table rows of its
    sequences, rebased to the slice.  The write slots are made here, from
    the rebased table and the local lengths (slots from the global table
    would put the new token in another rank's frame numbering)."""
    return _paged_update_and_attend(
        q1, k1, v1, k_pool, v_pool,
        rebase_page_table(page_table, rank, p_local), lengths, window)


def _paged_update_and_attend_dist(q1, k1, v1, k_pool, v_pool, page_table,
                                  lengths, window: int, slots=None):
    """Locality-explicit variant: the reference's ``shard_map`` region.

    Pool pages and batch rows are co-sharded over the data axes (the
    engine's identity page layout puts sequence b's pages on b's shard),
    so each rank gathers from its own pool slice and no collective runs.
    Heads also split over ``'model'`` when both the query and KV head
    counts divide it (GQA grouping stays shard-local).

    The inputs are DTensors on the active DeviceMesh; each is laid out as
    the region wants it, the shard-local body runs on ``.to_local()`` (a
    CUDA shard launches the paged-attention kernel, a CPU one runs its
    plain version), and the outputs come back as DTensors with the
    region's placements.  Without a data split (the conditions of
    :func:`data_shards`), or on plain tensors, which are whole on every
    rank, the local body runs on the whole batch with ``slots``.
    Returns (out, k_pool, v_pool).
    """
    shards = data_shards(q1.shape[0], k_pool.shape[0])
    if shards is None or not logical.is_dtensor(q1):
        return _paged_update_and_attend(q1, k1, v1, k_pool, v_pool,
                                        page_table, lengths, window, slots)
    from torch.distributed.tensor import DTensor
    mesh, d, dsize = shards
    msize = logical.mesh_shape(mesh).get("model", 1)
    H, KVH = q1.shape[1], k1.shape[1]
    head_tp = "model" in mesh.mesh_dim_names and H % msize == 0 \
        and KVH % msize == 0
    h = "model" if head_tp else None
    row = logical.placements(mesh, P(d, h))
    pool = logical.placements(mesh, P(d, None, h))
    vec = logical.placements(mesh, P(d))
    local = [x.redistribute(mesh, pl).to_local() for x, pl in zip(
        (q1, k1, v1, k_pool, v_pool, page_table, lengths),
        (row, row, row, pool, pool, vec, vec))]
    out, kp, vp = paged_shard_local(*local, window, data_rank(mesh, d),
                                    k_pool.shape[0] // dsize)
    return (DTensor.from_local(out, mesh, row, run_check=False),
            DTensor.from_local(kp, mesh, pool, run_check=False),
            DTensor.from_local(vp, mesh, pool, run_check=False))


def apply_attention_decode_paged(p, cfg: ModelConfig, x, k_pool, v_pool,
                                 page_table, lengths, rope=None, slots=None):
    """One-token decode through the paged KV pool.

    x: (B, 1, d).  ``lengths`` counts tokens *including* the current one.
    The new token's K/V is written into its page (uniform offset across the
    batch — decode steps are in lockstep), then attention reads the whole
    context through the page table.  ``k_pool`` / ``v_pool`` are updated in
    place.  ``rope`` / ``slots`` are the step's precomputed ``rope_tables``
    and ``paged_write_slots`` (both made here when absent).
    Returns (out, k_pool, v_pool).
    """
    B = x.shape[0]
    pos = lengths - 1                                     # (B,) current index
    q, k, v = _qkv(p, cfg, x, pos[:, None], rope)
    q1, k1, v1 = q[:, 0].contiguous(), k[:, 0], v[:, 0]
    out, k_pool, v_pool = _paged_update_and_attend_dist(
        q1, k1, v1, k_pool, v_pool, page_table, lengths, cfg.sliding_window,
        slots)
    out = out.reshape(B, cfg.n_heads * cfg.head_dim) @ p["wo"]
    return out[:, None, :], k_pool, v_pool


def apply_attention_decode_ring(p, cfg: ModelConfig, x, k_ring, v_ring,
                                lengths, rope=None):
    """One-token decode over a sliding-window ring buffer (SWA archs).

    The ring IS the resident set: everything older than the window has
    been dropped.  The whole batch writes at the slot of row 0
    (``pos[0] % W``, lockstep); ``k_ring`` / ``v_ring`` are updated in
    place.  Returns (out, k_ring, v_ring).
    """
    B = x.shape[0]
    W = k_ring.shape[1]
    pos = lengths - 1
    q, k, v = _qkv(p, cfg, x, pos[:, None], rope)
    q1, k1, v1 = q[:, 0], k[:, 0], v[:, 0]
    slot = torch.remainder(pos[:1], W).long()             # (1,)
    k_ring.index_copy_(1, slot, k1[:, None])
    v_ring.index_copy_(1, slot, v1[:, None])
    out = ring_buffer_attention(q1, k_ring, v_ring, lengths,
                                cfg.sliding_window)
    out = out.reshape(B, cfg.n_heads * cfg.head_dim) @ p["wo"]
    return out[:, None, :], k_ring, v_ring
