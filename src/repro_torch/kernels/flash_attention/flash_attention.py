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
take Sq query rows over Sk keys, Sq != Sk without a causal mask or a window
only (:func:`check_shapes`) — the cross-attention of the encoder-decoder
family, whose plain version (``flash_attention_xla``) takes the same.

Two routes, picked by :func:`route` from the dtype alone: bfloat16 (the
training path's dtype) runs on the tensor cores (``csrc/
flash_attention_tc.cu``), float32 on the CUDA cores
(``csrc/flash_attention.cu``).  Each dtype has exactly one route, and there
is no fallback between them.  CUDA tensors only; :mod:`.ops` routes CPU
tensors to the plain version.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels._build import check_launch, load_library

NEG_INF = -1e30                # a masked score (the kernels' kNegInf)
SUPPORTED_HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128, 192)


class Route(NamedTuple):
    """The C entry points of one route, forward and backward."""
    fwd: str
    bwd: str


TENSOR_CORES = Route("repro_flash_attention_tc_fwd",
                     "repro_flash_attention_tc_bwd")
CUDA_CORES = Route("repro_flash_attention_fwd", "repro_flash_attention_bwd")


def route(dtype: torch.dtype, head_dim: int) -> Route:
    """bfloat16 -> the tensor-core kernels (bf16 operands, f32
    accumulators); float32 -> the f32 CUDA-core kernels (TF32 products
    would fail the f32 tolerances).  Raises ``ValueError`` for any other
    dtype or a head dim outside ``SUPPORTED_HEAD_DIMS``."""
    if head_dim not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention_kernel: head_dim {head_dim} not "
                         f"in {SUPPORTED_HEAD_DIMS}")
    if dtype == torch.bfloat16:
        return TENSOR_CORES
    if dtype == torch.float32:
        return CUDA_CORES
    raise ValueError(f"flash_attention_kernel: dtype {dtype} (float32 or "
                     f"bfloat16 only)")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention_kernel: {msg}")


def check_shapes(q_shape, k_shape, v_shape, causal: bool, window: int):
    """(B, Sq, Sk, H, KVH, D) of q (B, Sq, H, D) over k, v (B, Sk, KVH, D),
    from shapes alone.  Raises ``ValueError`` for a mismatch, and for
    Sq != Sk with ``causal`` or a window: the kernels serve Sq != Sk
    non-causal and unwindowed only (the reference's one use of it)."""
    _require(len(q_shape) == 4 and len(k_shape) == 4
             and tuple(v_shape) == tuple(k_shape),
             "expected q (B,Sq,H,D), k and v (B,Sk,KVH,D)")
    B, Sq, H, D = q_shape
    Sk, KVH = k_shape[1], k_shape[2]
    _require(k_shape[0] == B and k_shape[3] == D,
             f"k {tuple(k_shape)} does not match q {tuple(q_shape)}")
    _require(Sq > 0 and Sk > 0, "empty sequence")
    _require(Sq == Sk or (not causal and window <= 0),
             f"Sq {Sq} != Sk {Sk} needs causal=False and no window "
             f"(causal={bool(causal)}, window={window})")
    _require(H % KVH == 0, f"{H} query heads not a multiple of {KVH} KV heads")
    _require(B <= 65535 and H <= 65535, "batch or heads above 65535")
    return B, Sq, Sk, H, KVH, D


def _check(q, k, v, causal: bool, window: int):
    _require(q.is_cuda, "q must be a CUDA tensor")
    for name, t in (("k", k), ("v", v)):
        _require(t.device == q.device, f"{name} is on {t.device}, q on "
                 f"{q.device}")
    _require(k.dtype == q.dtype and v.dtype == q.dtype,
             "q, k and v must share one dtype")
    shapes = check_shapes(q.shape, k.shape, v.shape, causal, window)
    return shapes + (route(q.dtype, shapes[-1]),)


def _rows_aligned(t) -> bool:
    """Unit stride over D and 16-byte aligned rows: read as it lies."""
    vec = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % vec == 0 for s in t.stride()[:3]))


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, Sq, H, D); k, v: (B, Sk, KVH, D).  Returns ``(o, lse)``: o
    (B, Sq, H, D) in q's dtype, contiguous; lse (B, H, Sq) f32, the
    logsumexp of each row's scaled, masked scores.  Sq != Sk only with
    ``causal=False`` and no window (:func:`check_shapes`).

    q, k and v are read through their strides as they lie when each has
    unit stride over D and 16-byte aligned rows (what the model path gives:
    the outputs of RoPE and of a projection's reshape); a tensor that does
    not is copied once to a contiguous tensor.  k and v must then share
    strides.  Launches on the current stream and does not synchronise.
    """
    B, Sq, Sk, H, KVH, D, r = _check(q, k, v, causal, window)
    q, k, v = (t if _rows_aligned(t) else t.contiguous() for t in (q, k, v))
    if v.stride() != k.stride():
        k, v = k.contiguous(), v.contiguous()
    o = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib = load_library()
    with torch.cuda.device(q.device):
        code = getattr(lib, r.fwd)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, Sq, Sk, H, KVH, D, *q.stride()[:3],
            *k.stride()[:3], int(bool(causal)), int(window),
            torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(code, "flash_attention")
    LAUNCHES["flash_attention"] += 1
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


def flash_attention_bwd(q, k, v, o, lse, dout, *, causal: bool = True,
                        window: int = 0):
    """Gradients ``(dq, dk, dv)`` of :func:`flash_attention_fwd` for the
    output gradient ``dout`` (B, Sq, H, D), from the forward's ``o`` and
    ``lse``.  Every operand is made contiguous (a no-op on the model path);
    the results are contiguous, in q's dtype.  On the current stream, no
    atomics: bf16 two launches (dQ, which also forms rowsum(dout * o), then
    dK/dV), f32 three (the row sums, dK/dV, dQ)."""
    B, Sq, Sk, H, KVH, D, r = _check(q, k, v, causal, window)
    _require(o.shape == q.shape and dout.shape == q.shape
             and lse.shape == (B, H, Sq), "o, dout or lse shape")
    _require(o.dtype == q.dtype and lse.dtype == torch.float32,
             "o must have q's dtype and lse float32")
    dout = dout.to(q.dtype)
    q, k, v, o, lse, dout = (t.contiguous() for t in (q, k, v, o, lse, dout))
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = load_library()
    with torch.cuda.device(q.device):
        code = getattr(lib, r.bwd)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, H, KVH, D,
            int(bool(causal)), int(window),
            torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(code, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv
