"""GQA attention layer: projections + RoPE + qk-norm + SWA + paged decode.

Training / prefill attention (:func:`apply_attention`) calls the
hand-written flash-attention kernels through
``kernels.flash_attention.ops.flash_attention``; the paged decode path calls
the hand-written kernel through ``kernels.paged_attention.ops.paged_attention``.
Plain tensors go to the wrappers whole; DTensors go through a region
(:func:`_flash_dist`, :func:`_paged_update_and_attend_dist`) that hands
the wrappers each rank's local shards.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed import logical
from repro_torch.distributed.logical import PartitionSpec as P, constrain, \
    grad_like
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


def _split_heads(t, n: int, hd: int, seq_split: bool = False):
    """(B, S, n * hd) -> (B, S, n, hd).  A DTensor split over a mesh dim
    whose size does not divide ``n`` cannot be unflattened in place: that
    dim moves to the sequence (``seq_split``, when it divides S: the
    reference's ``q_seq`` rule) or is gathered (K/V stay replicated)."""
    B, S, _ = t.shape
    if logical.is_dtensor(t):
        from torch.distributed.tensor import Replicate, Shard
        mesh = t.device_mesh
        pl = list(t.placements)
        for i, p in enumerate(pl):
            if p.is_shard(2) and n % mesh.size(i):
                seq = seq_split and S % mesh.size(i) == 0 \
                    and not any(o.is_shard(1) for o in pl)
                pl[i] = Shard(1) if seq else Replicate()
        if pl != list(t.placements):
            t = t.redistribute(mesh, pl)
    return t.reshape(B, S, n, hd)


def _merge_heads(t):
    """(B, S, n, hd) -> (B, S, n * hd) for the row-parallel output
    projection.  A DTensor split over the sequence has that mesh dim moved
    to the features: DTensor can neither fold a batch and a sequence split
    into one matmul dim nor, in the backward, unflatten a feature split
    that does not divide ``n`` — so the merged tensor's gradient is laid
    out like it (``grad_like``), not split over the features as the
    projection's backward leaves it."""
    B, S, n, hd = t.shape
    t = grad_like(t.reshape(B, S, n * hd))
    if logical.is_dtensor(t) and any(p.is_shard(1) for p in t.placements):
        from torch.distributed.tensor import Replicate, Shard
        mesh = t.device_mesh
        t = t.redistribute(mesh, [
            (Shard(2) if n * hd % mesh.size(i) == 0 else Replicate())
            if p.is_shard(1) else p for i, p in enumerate(t.placements)])
    return t


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
    q = _split_heads(q, H, hd, seq_split=True)
    k = _split_heads(k, KVH, hd)
    v = _split_heads(v, KVH, hd)
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
    out = _flash_dist(q, k, v, causal=causal,
                      window=cfg.sliding_window if causal else 0,
                      q_chunk=q_chunk, kv_chunk=kv_chunk)
    out = constrain(out, "batch", "q_seq", "heads", "head_dim")
    out = _merge_heads(out) @ p["wo"]
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


def _data_split(mesh, batch: int, pages: int) -> tuple:
    """(data axes, data size) of a kernel's region on ``mesh``: those of
    :func:`data_shards` when the active rules are on this mesh, else
    (None, 1), every rank taking the whole batch."""
    shards = data_shards(batch, pages)
    if shards is None or shards[0] != mesh:
        return None, 1
    return shards[1], shards[2]


def _head_split(mesh, heads: int, kv_heads: int):
    """``"model"`` when the mesh has that dim and both head counts divide
    its size (GQA grouping stays shard-local), else None."""
    if "model" not in mesh.mesh_dim_names:
        return None
    m = logical.mesh_shape(mesh)["model"]
    return "model" if heads % m == 0 and kv_heads % m == 0 else None


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

    Plain tensors, which are whole on every rank, go to the local body on
    the whole batch with ``slots``.  DTensors always go through the
    region: each is laid out as the region wants it, the shard-local body
    runs on ``.to_local()`` (a CUDA shard launches the paged-attention
    kernel, a CPU one runs its plain version), and the outputs come back
    as DTensors with the region's placements.  Without a data split (the
    conditions of :func:`data_shards`) every rank takes the whole batch and
    pool.  A pool whose placements differ from the region's was copied by
    the layout, so the written pool is copied back into it: the caller's
    pools hold the new token's K/V either way.
    Returns (out, k_pool, v_pool).
    """
    if not logical.is_dtensor(q1):
        return _paged_update_and_attend(q1, k1, v1, k_pool, v_pool,
                                        page_table, lengths, window, slots)
    from torch.distributed.tensor import DTensor
    mesh = q1.device_mesh
    d, dsize = _data_split(mesh, q1.shape[0], k_pool.shape[0])
    h = _head_split(mesh, q1.shape[1], k1.shape[1])
    row = logical.placements(mesh, P(d, h))
    pool = logical.placements(mesh, P(d, None, h))
    vec = logical.placements(mesh, P(d))
    local = [x.redistribute(mesh, pl).to_local() for x, pl in zip(
        (q1, k1, v1, k_pool, v_pool, page_table, lengths),
        (row, row, row, pool, pool, vec, vec))]
    out, kp, vp = paged_shard_local(
        *local, window, data_rank(mesh, d) if d else 0,
        k_pool.shape[0] // dsize)
    _write_back(((k_pool, kp), (v_pool, vp)), mesh, pool)
    return tuple(DTensor.from_local(x, mesh, pl, run_check=False)
                 for x, pl in ((out, row), (kp, pool), (vp, pool)))


def _flash_dist(q, k, v, *, causal: bool, window: int = 0,
                q_chunk: int = 512, kv_chunk: int = 512):
    """The flash kernels' region for training / prefill attention.

    Plain tensors go to ``flash_attention`` as they are.  DTensors are laid
    out as the region wants them and the kernel (or, on the CPU, its plain
    version) runs on each rank's ``.to_local()`` shards: batch over the
    data axes when it splits evenly (:func:`data_shards`), heads over
    ``'model'`` when both head counts divide it, else the query sequence
    over ``'model'`` (the reference's ``q_seq`` rule), each rank's rows at
    their offset and K/V whole: the kernels take the offset (``q_offset``,
    rank 0's 0 given explicitly) and mask by each row's absolute position.
    Cross-attention (``Sq != Sk``) takes no
    sequence split: where neither the batch nor the heads divide, Q and
    K/V go whole to every rank.  ``to_local`` and ``from_local`` are
    differentiable, so the backward kernels get local tensors too; under
    the sequence split each rank's K/V gradient is a part of the sum
    (``Partial``).  Returns a DTensor with the query's region placements.
    """
    kw = dict(causal=causal, window=window, q_chunk=q_chunk,
              kv_chunk=kv_chunk)
    if not logical.is_dtensor(q):
        return flash_attention(q, k, v, **kw)
    from torch.distributed.tensor import DTensor, Partial
    mesh = q.device_mesh
    B, S, H, _ = q.shape
    d, _ = _data_split(mesh, B, B)
    h = _head_split(mesh, H, k.shape[2])
    m = logical.mesh_shape(mesh).get("model", 1)
    s = "model" if h is None and m > 1 and S == k.shape[1] \
        and S % m == 0 else None
    qp = logical.placements(mesh, P(d, s, h))
    kvp = logical.placements(mesh, P(d, None, h))
    grad = kvp
    if s:
        grad = list(kvp)
        grad[mesh.mesh_dim_names.index("model")] = Partial()
        kw["q_offset"] = mesh.get_local_rank("model") * (S // m)
    out = flash_attention(
        logical.local_shard(q, mesh, qp),
        *(logical.local_shard(t, mesh, kvp, tuple(grad)) for t in (k, v)),
        **kw)
    return DTensor.from_local(out, mesh, qp, run_check=False)


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


def _ring_slot(lengths, window: int):
    """(1,) ring slot the whole batch writes: that of row 0, ``pos[0] %
    W`` (decode steps are in lockstep)."""
    return torch.remainder(lengths[:1] - 1, window).long()


def _ring_update_and_attend(q1, k1, v1, k_ring, v_ring, lengths,
                            window: int, slot):
    """Write the new token's K/V at ``slot`` (:func:`_ring_slot`), then
    attend over the ring; the rings are updated in place (and
    returned)."""
    k_ring.index_copy_(1, slot, k1[:, None])
    v_ring.index_copy_(1, slot, v1[:, None])
    return ring_buffer_attention(q1, k_ring, v_ring, lengths, window), \
        k_ring, v_ring


def _ring_update_and_attend_dist(q1, k1, v1, k_ring, v_ring, lengths,
                                 window: int):
    """The ring decode's region, laid out as the paged one's: plain tensors
    go to the body whole; DTensors run it on each rank's ``.to_local()``
    rows (batch over the data axes when it splits, heads over ``'model'``
    when both head counts divide it), and a ring laid out otherwise gets
    the written ring copied back.  The slot is the whole batch's row 0's,
    as without the region (not each rank's first row).  Returns (out,
    k_ring, v_ring)."""
    slot = _ring_slot(lengths, k_ring.shape[1])
    if not logical.is_dtensor(q1):
        return _ring_update_and_attend(q1, k1, v1, k_ring, v_ring, lengths,
                                       window, slot)
    from torch.distributed.tensor import DTensor
    mesh = q1.device_mesh
    d, _ = _data_split(mesh, q1.shape[0], q1.shape[0])
    h = _head_split(mesh, q1.shape[1], k1.shape[1])
    row = logical.placements(mesh, P(d, h))
    ring = logical.placements(mesh, P(d, None, h))
    local = [x.redistribute(mesh, pl).to_local() for x, pl in zip(
        (q1, k1, v1, k_ring, v_ring, lengths),
        (row, row, row, ring, ring, logical.placements(mesh, P(d))))]
    out, kr, vr = _ring_update_and_attend(*local, window,
                                          logical.full(slot))
    _write_back(((k_ring, kr), (v_ring, vr)), mesh, ring)
    return DTensor.from_local(out, mesh, row, run_check=False), k_ring, \
        v_ring


def _write_back(pairs, mesh, placements: tuple) -> None:
    """Copy each buffer a region wrote (local, laid out as ``placements``)
    into the caller's DTensor where the region's layout made a copy: the
    decoder drops the buffers a region returns and relies on its own
    being written in place."""
    from torch.distributed.tensor import DTensor
    for cached, written in pairs:
        if tuple(cached.placements) != placements:
            cached.copy_(DTensor.from_local(
                written, mesh, placements, run_check=False).redistribute(
                mesh, cached.placements))


def apply_attention_decode_ring(p, cfg: ModelConfig, x, k_ring, v_ring,
                                lengths, rope=None):
    """One-token decode over a sliding-window ring buffer (SWA archs).

    The ring IS the resident set: everything older than the window has
    been dropped.  The whole batch writes at the slot of row 0
    (``pos[0] % W``, lockstep); ``k_ring`` / ``v_ring`` are updated in
    place.  Returns (out, k_ring, v_ring).
    """
    B = x.shape[0]
    pos = lengths - 1
    q, k, v = _qkv(p, cfg, x, pos[:, None], rope)
    out, k_ring, v_ring = _ring_update_and_attend_dist(
        q[:, 0], k[:, 0], v[:, 0], k_ring, v_ring, lengths,
        cfg.sliding_window)
    out = out.reshape(B, cfg.n_heads * cfg.head_dim) @ p["wo"]
    return out[:, None, :], k_ring, v_ring
