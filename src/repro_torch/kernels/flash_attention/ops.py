"""Model-layout wrapper for training / prefill attention.

    q (B, Sq, H, D);  k, v (B, Sk, KVH, D)  ->  (B, Sq, H, D)

Sq != Sk (cross-attention) goes to the kernels with ``causal=False`` and
no window only; they raise ``ValueError`` for the rest.

A CUDA tensor goes to the hand-written kernels through
:class:`FlashAttention`, a ``torch.autograd.Function`` whose forward
launches the forward kernel (saving q, k, v, o and the per-row
logsumexp) and whose backward launches the backward kernels — there is
no autograd through a plain version on the GPU, and no fallback: a build
or launch failure raises.  A CPU tensor, and only a CPU tensor, takes the
plain chunked version ``models.attention_ops.flash_attention_xla``, which
autograd differentiates there.  A DTensor raises ``TypeError`` on any
device.  ``q_offset`` (the absolute position of ``q[:, 0]``, non-zero for
a rank's rows of a sequence split over ranks) reaches the plain version
only: the kernels take none, and raise ``ValueError`` for it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import require_local
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_bwd, flash_attention_fwd)
from repro_torch.models.attention_ops import flash_attention_xla


class FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, dout,
                                         causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_chunk: int = 512, kv_chunk: int = 512,
                    q_offset: int = 0):
    """``q_chunk`` / ``kv_chunk`` shape the plain CPU version only; the
    kernels use their own tiles."""
    require_local(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_xla(q, k, v, causal=causal, window=window,
                                   q_chunk=q_chunk, kv_chunk=kv_chunk,
                                   q_offset=q_offset)
    if q_offset:
        raise ValueError(f"flash_attention_kernel: q_offset {q_offset}: the "
                         "kernels take query rows from position 0 only")
    return FlashAttention.apply(q, k, v, bool(causal), int(window))
