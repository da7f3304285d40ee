"""Token sampling: greedy / temperature / top-k / top-p."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0     # 0 = greedy
    top_k: int = 0
    top_p: float = 1.0


def sample_token(logits, cfg: SamplerConfig,
                 generator: Optional[torch.Generator] = None):
    """logits: (B, V) -> (B,) int32.

    Greedy is deterministic and matches the reference token for token;
    the sampled modes draw from ``generator`` (on the logits' device),
    whose stream differs from the reference's.
    """
    logits = logits.float()
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / cfg.temperature
    if cfg.top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -cfg.top_k][:, None]
        logits = torch.where(logits < kth, torch.full_like(logits, -1e30),
                             logits)
    if cfg.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        cutoff_idx = (cum < cfg.top_p).sum(dim=-1)
        cutoff_idx = cutoff_idx.clamp(max=logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, 1, cutoff_idx[:, None])
        logits = torch.where(logits < cutoff, torch.full_like(logits, -1e30),
                             logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0] \
        .to(torch.int32)
