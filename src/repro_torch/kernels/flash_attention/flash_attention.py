"""Binding of the CUDA flash-attention kernels.

Counterpart of the reference's Pallas ``flash_attention_kernel``, with three
differences.  Layout: the kernels take the **model layout** ``(B, Sq, H, D)``
/ ``(B, Sk, KVH, D)`` directly, so the reference wrapper's three transposes
are gone (:func:`flash_attention_kernel` keeps the reference's signature
and ``(B, H, S, D)`` layout as strided views over the same forward).
Gradient: the forward also returns the per-row logsumexp
``lse (B, H, Sq)`` (f32), from which :func:`flash_attention_bwd` computes
dq, dk, dv with hand-written kernels; the reference differentiates its
chunked scan with XLA instead.  Shape: the Pallas kernel takes one S; these
take Sq query rows over Sk keys (:func:`check_shapes`): without a causal
mask or a window at any Sq, Sk — the cross-attention of the
encoder-decoder family — and, given a query offset ``q_offset``, with them
too: row i of q sits at absolute position ``q_offset + i`` of the keys
(one rank's rows of a sequence split over ranks), as in the plain version
``flash_attention_xla``.

Two routes, picked by :func:`route` from the dtype alone, both on the
tensor cores with wgmma on tiles that TMA copies into shared memory and a
producer warp beside the consumers: bfloat16 (the training path's dtype;
the forward in ``csrc/flash_attention_wgmma.cu``, the backward in ``csrc/
flash_attention_wgmma_bwd.cu``) and float32 as error-compensated TF32
(``csrc/flash_attention.cu``: each operand split into a TF32 big and
small part, three products summed in f32, as accurate as f32 products).
Each dtype has exactly one route, and there is no fallback between them.
A forward of at most ``DECODE_MAX_ROWS`` query rows (decode: Whisper's
cross-attention at Sq = 1) takes, in either
dtype, the split-KV decode kernel (``csrc/flash_decode.cu``) instead:
:func:`forward_entry` decides from the shapes alone, and its ``lse`` feeds
the dtype's backward unchanged.  CUDA tensors only; :mod:`.ops` routes CPU
tensors to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import numbers
from typing import NamedTuple

import torch

from repro_torch.kernels import LAUNCHES, ROUTE_LAUNCHES
from repro_torch.kernels._build import check_launch, load_library, sm_count

NEG_INF = -1e30                # a masked score (the kernels' kNegInf)
SUPPORTED_HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128, 192)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class Route(NamedTuple):
    """The C entry points of one route, forward and backward."""
    fwd: str
    bwd: str


TENSOR_CORES = Route("repro_flash_attention_tc_fwd",
                     "repro_flash_attention_tc_bwd")
F32 = Route("repro_flash_attention_fwd", "repro_flash_attention_bwd")


def route(dtype: torch.dtype, head_dim: int) -> Route:
    """bfloat16 -> the bf16 kernels (bf16 operands, f32 accumulators);
    float32 -> the f32 kernels, 3xTF32 on the tensor cores (one TF32
    product keeps three decimal digits, too few for the f32 tolerances;
    three of split operands keep f32's).  Raises ``ValueError`` for any
    other dtype or a head dim outside ``SUPPORTED_HEAD_DIMS``."""
    if head_dim not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention_kernel: head_dim {head_dim} not "
                         f"in {SUPPORTED_HEAD_DIMS}")
    if dtype == torch.bfloat16:
        return TENSOR_CORES
    if dtype == torch.float32:
        return F32
    raise ValueError(f"flash_attention_kernel: dtype {dtype} (float32 or "
                     f"bfloat16 only)")


# A forward of at most this many query rows takes the decode kernel: over
# 1,500 keys at B = 1 and 4 it is no slower than the tile kernels at every
# Sq up to here with 1, 5 and 12 query heads a KV head in both dtypes
# (tools/flash_decode_sweep.py, PERF.md); at Sq = 16 it loses in bf16 where
# G > 1, since each of its row groups re-reads the KV head's keys
DECODE_MAX_ROWS = 8
DECODE = "repro_flash_decode_fwd"
# key rows of a decode stage (flash_decode.cu's Elem<T>::kTile)
DECODE_TILE_ROWS = {torch.float32: 32, torch.bfloat16: 128}
MAX_CLUSTER = 8              # the portable cluster size; the kernel's limit


def forward_entry(dtype: torch.dtype, head_dim: int, Sq: int) -> str:
    """The C entry point of a forward call, from shapes alone: the decode
    kernel for ``Sq <= DECODE_MAX_ROWS`` query rows, else the dtype's
    route (:func:`route`, which also raises for what no kernel takes)."""
    r = route(dtype, head_dim)
    return DECODE if Sq <= DECODE_MAX_ROWS else r.fwd


def decode_rows_per_block(rows: int, head_dim: int, dtype) -> int:
    """Query rows a decode block holds (``flash_decode.cu``'s kR) for the
    ``G * Sq`` rows of a KV head: 1, 2 or 4 where they fit, at most
    ``kMaxRows`` (bf16 4 at head dims up to 64, 2 above; f32 8 and 4), the
    rest in further row groups."""
    small = head_dim <= 64
    most = (4 if small else 2) if dtype == torch.bfloat16 else \
        (8 if small else 4)
    return next((r for r in (1, 2, 4) if rows <= r <= most), most)


def decode_tiles(Sq: int, Sk: int, causal: bool, window: int, q_offset,
                 tile_rows: int) -> int:
    """Key tiles a decode block walks over all its cluster's shares: the
    tiles of ``[first, end)``, the keys that rows at ``q_offset ..
    q_offset + Sq - 1`` see, from the tile that holds ``first``."""
    off = q_offset or 0
    end = min(Sk, off + Sq) if causal else Sk
    first = max(0, off - window + 1) if window > 0 else 0
    start = first // tile_rows * tile_rows
    return max(0, -(-(end - start) // tile_rows))


def decode_plan(clusters: int, tiles: int, n_sm: int, *, active_clusters,
                max_cluster: int = MAX_CLUSTER) -> int:
    """Blocks a cluster (``N``) of a decode call, from shapes alone: doubled
    from 1 while the ``clusters`` (B x KVH x row groups) of N blocks leave
    SMs idle (``clusters * N < n_sm``), 2N is at most ``max_cluster`` and
    at most the key ``tiles`` (each block a tile or more), and
    ``active_clusters(2N)`` (clusters of 2N blocks the device holds at once)
    still holds them all: one wave that fills the card, or the largest
    cluster."""
    n = 1
    while (clusters * n < n_sm and 2 * n <= min(max_cluster, tiles)
           and clusters <= active_clusters(2 * n)):
        n *= 2
    return n


@functools.lru_cache(maxsize=None)
def decode_active_clusters(device_index: int, n_splits: int, D: int,
                           rows: int, dtype) -> int:
    """Clusters of ``n_splits`` blocks of the decode kernel for (dtype, D,
    rows of a KV head) that the device holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    count = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        code = load_library().repro_flash_decode_active_clusters(
            n_splits, D, rows, _DTYPE_CODES[dtype], ctypes.byref(count))
    check_launch(code, "flash_decode occupancy query")
    return count.value


@functools.lru_cache(maxsize=None)
def plan_decode_splits(device_index: int, B: int, KVH: int, rows: int,
                       D: int, tiles: int, dtype) -> int:
    """:func:`decode_plan` for a call on a device, with the device's own
    SM count and count of co-resident clusters."""
    groups = -(-rows // decode_rows_per_block(rows, D, dtype))
    return decode_plan(
        B * KVH * groups, tiles, sm_count(device_index),
        active_clusters=lambda n: decode_active_clusters(device_index, n, D,
                                                         rows, dtype))


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention_kernel: {msg}")


def check_shapes(q_shape, k_shape, v_shape, causal: bool, window: int,
                 q_offset=None):
    """(B, Sq, Sk, H, KVH, D) of q (B, Sq, H, D) over k, v (B, Sk, KVH, D),
    from shapes alone.  Raises ``ValueError`` for a mismatch.

    ``q_offset=None``: Sq != Sk only with ``causal=False`` and no window
    (cross-attention, the reference's one use of it).  An integer
    ``q_offset >= 0``: row i of q sits at absolute position
    ``q_offset + i``; with ``causal`` or a window the rows must lie inside
    the keys, ``q_offset + Sq <= Sk`` (a rank's rows of a sequence split).
    Any other offset raises."""
    _require(len(q_shape) == 4 and len(k_shape) == 4
             and tuple(v_shape) == tuple(k_shape),
             "expected q (B,Sq,H,D), k and v (B,Sk,KVH,D)")
    B, Sq, H, D = q_shape
    Sk, KVH = k_shape[1], k_shape[2]
    _require(k_shape[0] == B and k_shape[3] == D,
             f"k {tuple(k_shape)} does not match q {tuple(q_shape)}")
    _require(Sq > 0 and Sk > 0, "empty sequence")
    masked = bool(causal) or window > 0
    if q_offset is None:
        _require(Sq == Sk or not masked,
                 f"Sq {Sq} != Sk {Sk} needs causal=False and no window "
                 f"(causal={bool(causal)}, window={window}) or a q_offset")
    else:
        _require(isinstance(q_offset, numbers.Integral)
                 and not isinstance(q_offset, bool) and q_offset >= 0,
                 f"q_offset {q_offset!r} is not an integer >= 0")
        _require(not masked or q_offset + Sq <= Sk,
                 f"q_offset {q_offset} + Sq {Sq} > Sk {Sk} "
                 f"(causal={bool(causal)}, window={window})")
        _require(q_offset + Sq <= 2 ** 31 - 1, "q_offset + Sq above 2^31 - 1")
    _require(H % KVH == 0, f"{H} query heads not a multiple of {KVH} KV heads")
    _require(B <= 65535 and H <= 65535, "batch or heads above 65535")
    return B, Sq, Sk, H, KVH, D


def _check(q, k, v, causal: bool, window: int, q_offset):
    _require(q.is_cuda, "q must be a CUDA tensor")
    for name, t in (("k", k), ("v", v)):
        _require(t.device == q.device, f"{name} is on {t.device}, q on "
                 f"{q.device}")
    _require(k.dtype == q.dtype and v.dtype == q.dtype,
             "q, k and v must share one dtype")
    shapes = check_shapes(q.shape, k.shape, v.shape, causal, window,
                          q_offset)
    return shapes + (route(q.dtype, shapes[-1]),)


# The bf16 forward's instance of each head dim: its own at 64, 128 and
# 192, the next one up elsewhere (flash_attention_wgmma.cu's dispatch).
# The tensor maps carry the true head dim, so the copy zero-fills the
# columns past it, and o has only the true head dim's columns.
WGMMA_INSTANCES = (64, 128, 192)
WGMMA_ATOM = 64              # bf16 columns of a 128-byte swizzle atom: a box
WGMMA_ROWS = 128             # query rows a block (two warpgroups of 64)


def fwd_instance(head_dim: int) -> int:
    """The head dim of the bf16 forward's instance that serves
    ``head_dim``: the smallest of ``WGMMA_INSTANCES`` at or above it."""
    if head_dim not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention_kernel: head_dim {head_dim} not "
                         f"in {SUPPORTED_HEAD_DIMS}")
    return next(d for d in WGMMA_INSTANCES if d >= head_dim)


def fwd_key_tile(head_dim: int) -> int:
    """Keys a tile of the bf16 forward (``Tiles<D>::kBK``): 128 at the 64
    instance, 112 at 128, 64 at 192 (registers and shared memory)."""
    return {64: 128, 128: 112, 192: 64}[fwd_instance(head_dim)]


# The bf16 backward (flash_attention_wgmma_bwd.cu) takes the forward's
# instances.  dQ: a block is WGMMA_ROWS query rows over key tiles of
# :func:`bwd_dq_keys`; dK/dV: a block is WGMMA_ROWS keys over query tiles
# of BWD_DKDV_ROWS.  At the 192 instance dK/dV runs as two passes (dV,
# then dK), each with one accumulator.
BWD_DKDV_ROWS = 64


def bwd_instance(head_dim: int) -> int:
    """The head dim of the bf16 backward's instance that serves
    ``head_dim``: the forward's (:func:`fwd_instance`)."""
    return fwd_instance(head_dim)


def bwd_dq_keys(head_dim: int) -> int:
    """Keys a tile of the bf16 backward's dQ (``DqTiles<D>::kBK``): 64, or
    32 at the 192 instance (registers)."""
    return 32 if bwd_instance(head_dim) == 192 else 64


# The f32 route (flash_attention.cu, 3xTF32 on wgmma) takes the same
# instances; a block is F32_ROWS rows (one consumer warpgroup), and each
# instance's tiles are the source's REPRO_F32_TILES: forward keys a tile,
# dQ keys a tile, dK/dV query rows a tile.  At the 192 instance dK/dV runs
# as two passes (dV, then dK).
F32_ATOM = 32                # f32 columns of a 128-byte swizzle atom: a box
F32_ROWS = 64                # rows a block (wgmma's m64)
F32_TILES = {64: (64, 64, 64), 128: (64, 32, 32), 192: (32, 32, 32)}
MAX_SHARED_BYTES = 232448    # a block's dynamic shared memory on an H100


def f32_instance(head_dim: int) -> int:
    """The head dim of the f32 kernels' instance that serves
    ``head_dim``: the bf16 one (:func:`fwd_instance`)."""
    return fwd_instance(head_dim)


def f32_smem_bytes(kernel: str, D: int, dkdv_pass: str = "both") -> int:
    """Dynamic shared memory a block of the f32 ``kernel`` ("fwd", "dq"
    or "dkdv", with ``dkdv_pass`` "both", "dv" or "dk") asks at instance
    ``D``: the source's FwdTiles / DqTiles / KvTiles, as many ring stages
    (at most 4) as fit beside the tiles a block keeps."""
    fwd_keys, dq_keys, rows = F32_TILES[D]
    reserve, stages_max = 1024 + 128, 4

    def total(fixed, stage):
        stages = min((MAX_SHARED_BYTES - fixed - reserve) // stage,
                     stages_max)
        if stages < 1:
            raise ValueError(f"f32 {kernel} at D={D}: no stage fits")
        return fixed + stages * stage + (1 + 2 * stages) * 8 + 1024

    q = F32_ROWS * D * 4
    if kernel == "fwd":             # Q split once where a stage fits
        kv = fwd_keys * D * 4
        pre = (MAX_SHARED_BYTES - 2 * q - 4 * kv - reserve) // (2 * kv) >= 1
        return total((2 if pre else 1) * q + 4 * kv, 2 * kv)
    if kernel == "dq":              # Q, dO split once where 2 stages fit
        kv = dq_keys * D * 4
        pre = (MAX_SHARED_BYTES - 4 * q - 2 * kv - reserve) // (2 * kv) >= 2
        return total((4 if pre else 2) * q + 2 * kv, 2 * kv)
    if kernel == "dkdv":
        dv, dk = dkdv_pass != "dk", dkdv_pass != "dv"
        qt = rows * D * 4
        stat = ((rows + 4) * 4 + 127) // 128 * 128
        tiles = 1 + dk + 2 * dv + 2 * (dk and dv)
        return total(2 * q + tiles * qt, 2 * qt + 2 * stat)
    raise ValueError(f"f32 kernel {kernel!r}")


class TensorMap(NamedTuple):
    """A 4-d tensor map as ``hopper.cuh``'s ``tile_map`` (bf16) or
    ``tile_map_f32`` encodes it (innermost first): ``dims`` (head_dim,
    heads, S, B), ``strides`` in bytes of heads, S and B, ``box`` one
    128-byte atom (64 bf16 or 32 f32 columns) of ``rows`` rows of one
    head."""
    dims: tuple
    strides: tuple
    box: tuple


def tensor_map(t, rows: int) -> TensorMap:
    """The map of a (B, S, heads, head_dim) bf16 or f32 tensor ``t`` (q,
    k, v, o or dout in the model layout) whose box is ``rows`` rows: a dim
    of one never steps its stride, so it gets a valid one (heads:
    head_dim, B: S times the row stride).  Columns past head_dim and rows
    past S are out of bounds, and the copy writes zeros there."""
    B, S, heads, head_dim = t.shape
    sb, ss, sh = t.stride()[:3]
    if heads == 1:
        sh = head_dim
    if B == 1:
        sb = S * ss
    el = t.element_size()
    return TensorMap((head_dim, heads, S, B), (sh * el, ss * el, sb * el),
                     (128 // el, 1, rows, 1))


def _rows_aligned(t) -> bool:
    """Read as it lies: unit stride over D, a 16-byte aligned base and
    batch, sequence and head strides that are multiples of 16 bytes (every
    global stride of the kernels' tensor maps, :func:`tensor_map`, which
    also takes no stride at or above 2^40 bytes)."""
    el = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s * el % 16 == 0 and 0 <= s * el < 2 ** 40
                    for s in t.stride()[:3]))


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset=None):
    """q: (B, Sq, H, D); k, v: (B, Sk, KVH, D).  Returns ``(o, lse)``: o
    (B, Sq, H, D) in q's dtype, contiguous; lse (B, H, Sq) f32, the
    logsumexp of each row's scaled, masked scores.  ``q_offset``: the
    absolute position of q's row 0 (:func:`check_shapes`; ``None`` is 0
    and allows Sq != Sk only without a mask).  The kernel is
    :func:`forward_entry`'s, the decode kernel's cluster size
    :func:`plan_decode_splits`'.

    q, k and v are read through their strides as they lie when each has
    unit stride over D and 16-byte aligned rows (what the model path gives:
    the outputs of RoPE and of a projection's reshape); a tensor that does
    not is copied once to a contiguous tensor.  k and v must then share
    strides.  Launches on the current stream and does not synchronise.
    """
    B, Sq, Sk, H, KVH, D, r = _check(q, k, v, causal, window, q_offset)
    entry = forward_entry(q.dtype, D, Sq)
    q, k, v = (t if _rows_aligned(t) else t.contiguous() for t in (q, k, v))
    if v.stride() != k.stride():
        k, v = k.contiguous(), v.contiguous()
    o = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib = load_library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, Sq, Sk, H, KVH, D, *q.stride()[:3],
            *k.stride()[:3], int(bool(causal)), int(window),
            int(q_offset or 0))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if entry == DECODE:
            n = plan_decode_splits(
                q.device.index or 0, B, KVH, (H // KVH) * Sq, D,
                decode_tiles(Sq, Sk, causal, window, q_offset,
                             DECODE_TILE_ROWS[q.dtype]), q.dtype)
            code = lib.repro_flash_decode_fwd(*args, n,
                                              _DTYPE_CODES[q.dtype], stream)
        else:
            code = getattr(lib, entry)(*args, stream)
    check_launch(code, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    if entry == DECODE:
        ROUTE_LAUNCHES["flash_decode"] += 1
    elif entry == TENSOR_CORES.fwd:
        ROUTE_LAUNCHES["flash_wgmma_fwd"] += 1
    else:
        ROUTE_LAUNCHES["flash_f32_fwd"] += 1
    return o, lse


def flash_attention_kernel(q, k, v, *, causal: bool = True, window: int = 0):
    """The reference's name and layout: q (B, H, S, D); k, v (B, KVH, S, D)
    -> o (B, H, S, D).  Launches the forward kernel
    (:func:`flash_attention_fwd`) on the three tensors viewed in the model
    layout, which it reads through their strides, and returns ``o`` as a
    view in the reference's layout; the ``lse`` it also writes is dropped.
    The Pallas kernel's tile sizes and interpret mode have no counterpart:
    the CUDA kernels' tiles are their own, and a CPU tensor goes through
    ``ops.flash_attention``."""
    o, _ = flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal,
                               window=window)
    return o.transpose(1, 2)


def bwd_operands(q, k, v, o, lse, dout):
    """What a backward launch gets, in either route (each reads through
    tensor maps): ``(q, k, v, o, lse, dout, strides)``.  q, k, v, o and
    dout as they lie where
    :func:`_rows_aligned` takes them, else a contiguous copy (k and v both
    copied if their strides differ), lse contiguous with a 16-byte aligned
    base (its 1-d tensor map's), and ``strides`` the (batch, seq, head)
    element strides of q, k (and v), o and dout in the C entry's order."""
    lse = lse.contiguous()
    q, k, v, o, dout = (t if _rows_aligned(t) else t.contiguous()
                        for t in (q, k, v, o, dout))
    if v.stride() != k.stride():
        k, v = k.contiguous(), v.contiguous()
    if lse.data_ptr() % 16:
        lse = lse.clone()
    strides = (*q.stride()[:3], *k.stride()[:3], *o.stride()[:3],
               *dout.stride()[:3])
    return q, k, v, o, lse, dout, strides


def flash_attention_bwd(q, k, v, o, lse, dout, *, causal: bool = True,
                        window: int = 0, q_offset=None):
    """Gradients ``(dq, dk, dv)`` of :func:`flash_attention_fwd` for the
    output gradient ``dout`` (B, Sq, H, D), from the forward's ``o`` and
    ``lse``, at the forward's ``q_offset``.  Both dtypes read q, k, v, o
    and dout through their strides as they lie where :func:`_rows_aligned`
    takes them (the forward's rule: the model path's views and the
    reference signature's transposed ones) and copy the rest once.  The
    results are contiguous, in q's dtype, and every key row of dk, dv is
    written (zeros where no row of q sees the key).  On the current
    stream, no atomics: dQ, which also forms rowsum(dout * o), then dK/dV
    (two launches at the 192 instance, dK/dV in two passes); f32 takes one
    query head a dK/dV block and, for G = H / KVH > 1, one more launch
    that adds up the query heads' terms from f32 scratch (2 x B x Sk x H x
    D, allocated here)."""
    B, Sq, Sk, H, KVH, D, r = _check(q, k, v, causal, window, q_offset)
    _require(o.shape == q.shape and dout.shape == q.shape
             and lse.shape == (B, H, Sq), "o, dout or lse shape")
    _require(o.dtype == q.dtype and lse.dtype == torch.float32,
             "o must have q's dtype and lse float32")
    q, k, v, o, lse, dout, strides = bwd_operands(q, k, v, o, lse,
                                                  dout.to(q.dtype))
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Sk, KVH, D), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    ptrs = [t.data_ptr() for t in (q, k, v, o, dout, lse, delta, dq, dk, dv)]
    part = None                 # f32: the query heads' dK, dV terms (G > 1)
    if r == F32:
        if H > KVH:
            part = torch.empty((2, B, Sk, H, D), dtype=torch.float32,
                               device=q.device)
        ptrs.append(None if part is None else part.data_ptr())
    lib = load_library()
    with torch.cuda.device(q.device):
        code = getattr(lib, r.bwd)(
            *ptrs, B, Sq, Sk, H, KVH, D, *strides, int(bool(causal)),
            int(window), int(q_offset or 0),
            torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(code, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    if r == F32:
        ROUTE_LAUNCHES["flash_f32_bwd"] += 1
    return dq, dk, dv
