"""Binding of the CUDA paged-attention kernel (``csrc/paged_attention.cu``).

Counterpart of the reference's Pallas ``paged_attention_kernel``, with one
difference in layout: this kernel reads the pools in the **model layout**
``(P, ps, KVH, D)`` through their strides, so no caller ever transposes a
pool.  CUDA tensors only; :mod:`.ops` routes CPU tensors to :mod:`.ref`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels._build import check_launch, load_library

SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention_kernel: {msg}")


def paged_attention_kernel(q, k_pool, v_pool, page_table, lengths, *,
                           window: int = 0):
    """q: (B, H, D); k/v_pool: (P, ps, KVH, D); page_table: (B, NP) int32
    (-1 = unmapped); lengths: (B,) int32.  Returns (B, H, D) in q's dtype.

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
    out = torch.empty_like(q)
    lib = load_library()
    with torch.cuda.device(q.device):
        code = lib.repro_paged_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, KVH, G, D, NP, ps, sp, st, sh, int(window),
            _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(code, "paged_attention")
    LAUNCHES["paged_attention"] += 1
    return out
