"""Binding of the CUDA paged-attention kernel (``csrc/paged_attention.cu``).

Counterpart of the reference's Pallas ``paged_attention_kernel``, with one
difference in layout: this kernel reads the pools in the **model layout**
``(P, ps, KVH, D)`` through their strides, so no caller ever transposes a
pool.  CUDA tensors only; :mod:`.ops` routes CPU tensors to :mod:`.ref`.

The kernel splits each sequence's context over a cluster of ``N`` blocks
and combines the partial softmaxes inside the cluster (one launch a call).
``N`` comes from :func:`split_plan`, from shapes alone: the lengths live on
the device, and reading them would synchronise.

Head dims: the kernel is built for 16, 32, 64 and 128; 80 and 112 run the
128 instance, the columns past D zero-filled in shared memory and never
written out (:func:`instance_head_dim`).

Page sizes: every ``ps >= 1``.  A bulk copy moves ``gcd(ps, tile)`` rows of
one head (``tile`` = 64 rows in bf16, 32 in f32) where those span a
multiple of 128 bytes and a stage takes at most 32 copies; other page
sizes (odd ones, ``ps = 1``, small pages at head_dim 16) are copied row by
row with 16-byte ``cp.async`` copies (:func:`bulk_segment` returns 0).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels._build import check_launch, load_library, sm_count

NEG_INF = -1e30                # a masked score (the kernel's kNegInf)
SUPPORTED_HEAD_DIMS = (16, 32, 64, 80, 112, 128)
INSTANCE_HEAD_DIMS = (16, 32, 64, 128)   # csrc/paged_attention.cu's builds
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# rows of K and of V a ring stage holds (csrc/paged_attention.cu's kTile)
TILE_ROWS = {torch.float32: 32, torch.bfloat16: 64}
HEADS_PER_BLOCK = 8          # query heads a block at most (kMaxHeads)
MAX_CLUSTER = 8              # the portable cluster size; the kernel's limit


def split_plan(B: int, KVH: int, NP: int, ps: int, n_sm: int,
               max_cluster: int = MAX_CLUSTER, *, active_clusters,
               tile_rows: int = 64, head_groups: int = 1) -> int:
    """Blocks a cluster (``N``) for a call, from shapes only: the largest
    power of two, at most ``max_cluster`` and at most the tiles of the
    ``NP * ps`` capacity, whose ``B * KVH * head_groups`` clusters all fit
    on the card at once (``active_clusters(N)``: clusters of N blocks that
    the device holds at once); 1 where the clusters of one block already
    fill the card.  Clusters that do not fit would run in a second wave,
    as long as the first."""
    clusters = B * KVH * head_groups
    tiles = -(-(NP * ps) // tile_rows)
    n = 1
    while (2 * n <= min(max_cluster, tiles) and clusters < n_sm
           and clusters <= active_clusters(2 * n)):
        n *= 2
    return n


@functools.lru_cache(maxsize=None)
def active_clusters(device_index: int, n_splits: int, D: int, G: int,
                    dtype) -> int:
    """Clusters of ``n_splits`` blocks of the kernel for (dtype, D, G) that
    the device holds at once (``cudaOccupancyMaxActiveClusters``)."""
    count = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        code = load_library().repro_paged_attention_active_clusters(
            n_splits, D, G, _DTYPE_CODES[dtype], ctypes.byref(count))
    check_launch(code, "paged_attention occupancy query")
    return count.value


@functools.lru_cache(maxsize=None)
def plan_splits(device_index: int, B: int, KVH: int, G: int, D: int, NP: int,
                ps: int, dtype) -> int:
    """:func:`split_plan` for a call on a device, with the device's own
    count of co-resident clusters."""
    return split_plan(
        B, KVH, NP, ps, sm_count(device_index), tile_rows=TILE_ROWS[dtype],
        head_groups=-(-G // HEADS_PER_BLOCK),
        active_clusters=lambda n: active_clusters(device_index, n, D, G,
                                                  dtype))


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention_kernel: {msg}")


def instance_head_dim(D: int) -> int:
    """The head dim of the kernel instance that serves ``D``: ``D`` itself
    where it is built, else the next one up (its rows in shared memory are
    that wide)."""
    _require(D in SUPPORTED_HEAD_DIMS,
             f"head_dim {D} not in {SUPPORTED_HEAD_DIMS}")
    return min(d for d in INSTANCE_HEAD_DIMS if d >= D)


def bulk_segment(ps: int, D: int, dtype) -> int:
    """Rows one bulk copy moves at page size ``ps``: ``gcd(ps, tile)``,
    where its bytes in shared memory (rows of :func:`instance_head_dim`)
    are a multiple of 128 (a bulk tensor copy's alignment) and a stage
    needs at most 32 copies (one a producer lane); else 0, and the
    producer copies the pages row by row."""
    _require(ps >= 1, f"page size {ps}")
    tile = TILE_ROWS[dtype]
    seg = math.gcd(ps, tile)
    row_bytes = instance_head_dim(D) * dtype.itemsize
    return seg if seg * row_bytes % 128 == 0 and 32 * seg >= tile else 0


def paged_attention_kernel(q, k_pool, v_pool, page_table, lengths, *,
                           window: int = 0, n_splits=None):
    """q: (B, H, D); k/v_pool: (P, ps, KVH, D); page_table: (B, NP) int32
    (-1 = unmapped); lengths: (B,) int32.  Returns (B, H, D) in q's dtype.
    ``n_splits`` (blocks a cluster) overrides :func:`split_plan`; only
    checks of the kernel set it.

    Launches on the current stream and does not synchronise.  Raises on
    anything the kernel does not take; never falls back.
    """
    _require(q.is_cuda, "q must be a CUDA tensor")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("page_table", page_table), ("lengths", lengths)):
        _require(t.device == q.device, f"{name} is on {t.device}, q on "
                 f"{q.device}")
    _require(q.dtype in _DTYPE_CODES, f"dtype {q.dtype} (float32 or "
             f"bfloat16 only)")
    _require(k_pool.dtype == q.dtype and v_pool.dtype == q.dtype,
             "q, k_pool and v_pool must share one dtype")
    _require(page_table.dtype == torch.int32 and lengths.dtype == torch.int32,
             "page_table and lengths must be int32")
    _require(q.dim() == 3 and k_pool.dim() == 4 and page_table.dim() == 2
             and lengths.dim() == 1, "expected q (B,H,D), pools (P,ps,KVH,D), "
             "page_table (B,NP), lengths (B,)")
    B, H, D = q.shape
    P, ps, KVH, Dk = k_pool.shape
    _require(v_pool.shape == k_pool.shape, "k_pool and v_pool shapes differ")
    _require(v_pool.stride() == k_pool.stride(),
             "k_pool and v_pool strides differ")
    _require(Dk == D and D in SUPPORTED_HEAD_DIMS,
             f"head_dim {D} not in {SUPPORTED_HEAD_DIMS}")
    _require(H % KVH == 0, f"{H} query heads not a multiple of {KVH} KV heads")
    _require(page_table.shape[0] == B and lengths.shape[0] == B,
             "batch sizes differ")
    _require(q.is_contiguous() and page_table.is_contiguous()
             and lengths.is_contiguous(),
             "q, page_table and lengths must be contiguous")
    sp, st, sh, sd = k_pool.stride()
    vec = 16 // q.element_size()           # elements per 16-byte load
    _require(sd == 1, "pools need unit stride over head_dim")
    _require(sp % vec == 0 and st % vec == 0 and sh % vec == 0
             and k_pool.data_ptr() % 16 == 0 and v_pool.data_ptr() % 16 == 0,
             "pool rows must be 16-byte aligned")
    _require(B <= 65535, "batch above 65535")
    G = H // KVH
    NP = page_table.shape[1]
    _require(NP * ps < 2 ** 31, "context capacity overflows int32")
    if n_splits is None:
        n_splits = plan_splits(q.device.index if q.device.index is not None
                               else torch.cuda.current_device(),
                               B, KVH, G, D, NP, ps, q.dtype)
    _require(1 <= n_splits <= MAX_CLUSTER,
             f"n_splits {n_splits} not in 1..{MAX_CLUSTER}")
    seg = bulk_segment(ps, D, q.dtype)
    out = torch.empty_like(q)
    lib = load_library()
    with torch.cuda.device(q.device):
        code = lib.repro_paged_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, KVH, G, D, P, NP, ps, seg, sp, st, sh, int(window),
            int(n_splits),
            _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(code, "paged_attention")
    LAUNCHES["paged_attention"] += 1
    return out
