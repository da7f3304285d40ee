"""Binding of the CUDA flash-attention kernels (``csrc/flash_attention.cu``).

Counterpart of the reference's Pallas ``flash_attention_kernel``, with two
differences.  Layout: the kernels take the **model layout** ``(B, S, H, D)``
/ ``(B, S, KVH, D)`` directly, so the reference wrapper's three transposes
are gone.  Gradient: the forward also returns the per-row logsumexp
``lse (B, H, S)`` (f32), from which :func:`flash_attention_bwd` computes
dq, dk, dv with hand-written kernels; the reference differentiates its
chunked scan with XLA instead.  CUDA tensors only; :mod:`.ops` routes CPU
tensors to the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels._build import check_launch, load_library

SUPPORTED_HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention_kernel: {msg}")


def _check(q, k, v):
    _require(q.is_cuda, "q must be a CUDA tensor")
    for name, t in (("k", k), ("v", v)):
        _require(t.device == q.device, f"{name} is on {t.device}, q on "
                 f"{q.device}")
    _require(q.dtype in _DTYPE_CODES, f"dtype {q.dtype} (float32 or "
             f"bfloat16 only)")
    _require(k.dtype == q.dtype and v.dtype == q.dtype,
             "q, k and v must share one dtype")
    _require(q.dim() == 4 and k.dim() == 4 and v.shape == k.shape,
             "expected q (B,S,H,D), k and v (B,S,KVH,D)")
    B, S, H, D = q.shape
    _require(k.shape[0] == B and k.shape[1] == S and k.shape[3] == D,
             f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    KVH = k.shape[2]
    _require(D in SUPPORTED_HEAD_DIMS,
             f"head_dim {D} not in {SUPPORTED_HEAD_DIMS}")
    _require(H % KVH == 0, f"{H} query heads not a multiple of {KVH} KV heads")
    _require(B <= 65535 and H <= 65535, "batch or heads above 65535")
    return B, S, H, KVH, D


def _rows_aligned(t) -> bool:
    """Unit stride over D and 16-byte aligned rows: read as it lies."""
    vec = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % vec == 0 for s in t.stride()[:3]))


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, S, H, D); k, v: (B, S, KVH, D).  Returns ``(o, lse)``: o
    (B, S, H, D) in q's dtype, contiguous; lse (B, H, S) f32, the
    logsumexp of each row's scaled, masked scores.

    q, k and v are read through their strides as they lie when each has
    unit stride over D and 16-byte aligned rows (what the model path gives:
    the outputs of RoPE and of a projection's reshape); a tensor that does
    not is copied once to a contiguous tensor.  k and v must then share
    strides.  Launches on the current stream and does not synchronise.
    """
    B, S, H, KVH, D = _check(q, k, v)
    q, k, v = (t if _rows_aligned(t) else t.contiguous() for t in (q, k, v))
    if v.stride() != k.stride():
        k, v = k.contiguous(), v.contiguous()
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    lib = load_library()
    with torch.cuda.device(q.device):
        code = lib.repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, S, H, KVH, D, *q.stride()[:3],
            *k.stride()[:3], int(bool(causal)), int(window),
            _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(code, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, dout, *, causal: bool = True,
                        window: int = 0):
    """Gradients ``(dq, dk, dv)`` of :func:`flash_attention_fwd` for the
    output gradient ``dout`` (B, S, H, D), from the forward's ``o`` and
    ``lse``.  Every operand is made contiguous (a no-op on the model path);
    the results are contiguous, in q's dtype.  Three launches (row sums
    rowsum(dout * o), dK/dV, dQ) on the current stream, no atomics."""
    B, S, H, KVH, D = _check(q, k, v)
    _require(o.shape == q.shape and dout.shape == q.shape
             and lse.shape == (B, H, S), "o, dout or lse shape")
    _require(o.dtype == q.dtype and lse.dtype == torch.float32,
             "o must have q's dtype and lse float32")
    dout = dout.to(q.dtype)
    q, k, v, o, lse, dout = (t.contiguous() for t in (q, k, v, o, lse, dout))
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = load_library()
    with torch.cuda.device(q.device):
        code = lib.repro_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, S, H, KVH, D,
            int(bool(causal)), int(window), _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(code, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv
