"""Model-layout wrapper for training / prefill attention.

    q (B, Sq, H, D);  k, v (B, Sk, KVH, D)  ->  (B, Sq, H, D)

``q_offset`` is the absolute position of ``q[:, 0]``: non-zero for a
rank's rows of a sequence split over ranks, whose K/V are the whole
sequence.  Given (as an integer, 0 included), the kernels take Sq != Sk
with a causal mask or a window when ``q_offset + Sq <= Sk``; left at
``None``, Sq != Sk goes to the kernels with ``causal=False`` and no
window only (cross-attention).  They raise ``ValueError`` for the rest,
before any launch.

A CUDA tensor goes to the hand-written kernels through
:class:`FlashAttention`, a ``torch.autograd.Function`` whose forward
launches the forward kernel (saving q, k, v, o and the per-row
logsumexp) and whose backward launches the backward kernels at the same
offset — there is no autograd through a plain version on the GPU, and no
fallback: a build or launch failure raises.  A CPU tensor, and only a CPU
tensor, takes the plain chunked version
``models.attention_ops.flash_attention_xla``, which autograd
differentiates there.  A DTensor raises ``TypeError`` on any device.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import require_local
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_bwd, flash_attention_fwd)
from repro_torch.models.attention_ops import flash_attention_xla


class FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, q_offset):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window, ctx.q_offset = causal, window, q_offset
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, dout,
                                         causal=ctx.causal, window=ctx.window,
                                         q_offset=ctx.q_offset)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_chunk: int = 512, kv_chunk: int = 512,
                    q_offset=None):
    """``q_chunk`` / ``kv_chunk`` shape the plain CPU version only; the
    kernels use their own tiles."""
    require_local(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_xla(q, k, v, causal=causal, window=window,
                                   q_chunk=q_chunk, kv_chunk=kv_chunk,
                                   q_offset=q_offset or 0)
    return FlashAttention.apply(q, k, v, bool(causal), int(window), q_offset)
