"""Model-layout wrapper for paged decode attention.

    q (B, H, D);  k/v_pool (P, ps, KVH, D);  page_table (B, NP); lengths (B,)

A CUDA tensor goes to the hand-written kernel (or raises — there is no
fallback); a CPU tensor, and only a CPU tensor, takes the plain version.
A DTensor raises ``TypeError`` on any device.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import require_local
from repro_torch.kernels.paged_attention.paged_attention import \
    paged_attention_kernel
from repro_torch.kernels.paged_attention.ref import paged_attention_ref


def paged_attention(q, k_pool, v_pool, page_table, lengths, *,
                    window: int = 0):
    require_local(q, k_pool, v_pool, page_table, lengths)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, page_table, lengths,
                                   window=window)
    return paged_attention_kernel(
        q, k_pool, v_pool, page_table.to(torch.int32),
        lengths.to(torch.int32), window=window)
