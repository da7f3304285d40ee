"""AdamW on nested-dict parameter trees: bf16-moment option, global-norm
clip.

Same arithmetic as the reference's (per leaf, f32, plain tensor ops — the
reference computes it in jnp, outside any Pallas kernel), with one
difference in form: :func:`update` updates the parameters and the state
(step and moments) **in place** and returns the same objects.  A
functional update of a full-width model would hold a second copy of the
parameters and both moments (about 29 GB at Qwen3-14B's width and 4
layers) beside the first.
Each leaf is updated in chunks of ``CHUNK_ELEMS`` elements, so the f32
temporaries of the largest leaf (the embedding) stay small; the update is
elementwise, so chunking changes no result.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.tree import tree_leaves, tree_map

CHUNK_ELEMS = 1 << 24


class AdamWState(NamedTuple):
    step: torch.Tensor          # 0-d int32
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"      # "bfloat16" halves optimizer memory
    schedule: Optional[Callable[[Any], Any]] = None


def init(cfg: AdamWConfig, params) -> AdamWState:
    dt = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32
    dev = tree_leaves(params)[0].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(x²), in f32."""
    return torch.sqrt(sum(
        torch.linalg.vector_norm(x.detach(), dtype=torch.float32).square()
        for x in tree_leaves(tree)))


def _chunks(t: torch.Tensor, writable: bool):
    # a tensor updated in place must be viewable as flat (raises if not)
    flat = t.view(-1) if writable else t.reshape(-1)
    for a in range(0, flat.numel(), CHUNK_ELEMS):
        yield flat[a:a + CHUNK_ELEMS]


@torch.no_grad()
def update(cfg: AdamWConfig, state: AdamWState, params, grads):
    """Returns (params, state, metrics); ``params`` and ``state`` (its step
    and moments) are updated in place and returned."""
    state.step.add_(1)
    step = state.step
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / gnorm.clamp(min=1e-12), max=1.0) \
        if cfg.grad_clip > 0 else 1.0
    lr = cfg.schedule(step) if cfg.schedule is not None else cfg.lr
    stepf = step.to(torch.float32)
    b1c = 1.0 - cfg.b1 ** stepf
    b2c = 1.0 - cfg.b2 ** stepf

    def upd(p, g, m, v):
        g = g.float() * scale
        m_new = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v_new = cfg.b2 * v.float() + (1 - cfg.b2) * torch.square(g)
        m_hat = m_new / b1c
        v_hat = v_new / b2c
        delta = m_hat / (torch.sqrt(v_hat) + cfg.eps) \
            + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m_new)
        v.copy_(v_new)

    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.mu), tree_leaves(state.nu)):
        for chunk in zip(_chunks(p, True), _chunks(g, False),
                         _chunks(m, True), _chunks(v, True)):
            upd(*chunk)
    metrics = {"grad_norm": gnorm,
               "lr": torch.as_tensor(lr, dtype=torch.float32)}
    return params, state, metrics
