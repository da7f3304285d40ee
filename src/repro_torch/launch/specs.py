"""input_specs(): shape-and-dtype stand-ins for every model input.

Tensors on the ``meta`` device: a shape and a dtype and no storage — the
dry-run traces against these (as fake tensors).  For training that is
{tokens, labels} (+ stub frame embeddings for the [audio] arch); for
decode it is the token batch plus the full decode-cache tree, built by
``init_decode_cache`` on ``meta`` (still no allocation).  The trees equal
the reference's ``jax.eval_shape`` trees leaf for leaf, but for the port's
sLSTM cache leaves, ``(1, B, d)`` where the reference's are ``(B, d)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.shapes import Shape
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import model_for


def _sds(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


@dataclasses.dataclass
class SpecBundle:
    kind: str                      # train | prefill | decode
    args: tuple                    # positional arg specs for the step fn
    cache: Any = None              # decode-cache spec tree (decode only)


def _frames(cfg: ModelConfig, batch: int):
    return _sds((batch, cfg.max_source_positions, cfg.d_model),
                torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32)


def train_specs(cfg: ModelConfig, shape: Shape) -> SpecBundle:
    B, S = shape.global_batch, shape.seq_len
    args = [_sds((B, S), torch.int32), _sds((B, S), torch.int32)]
    if cfg.is_encdec:
        args.append(_frames(cfg, B))
    return SpecBundle("train", tuple(args))


def prefill_specs(cfg: ModelConfig, shape: Shape) -> SpecBundle:
    B, S = shape.global_batch, shape.seq_len
    args = [_sds((B, S), torch.int32)]
    if cfg.is_encdec:
        args.append(_frames(cfg, B))
    return SpecBundle("prefill", tuple(args))


def decode_specs(cfg: ModelConfig, shape: Shape) -> SpecBundle:
    B, S = shape.global_batch, shape.seq_len
    cache_spec = model_for(cfg).init_decode_cache(cfg, B, S, device="meta")
    tokens = _sds((B, 1), torch.int32)
    return SpecBundle("decode", (tokens,), cache=cache_spec)


def input_specs(cfg: ModelConfig, shape: Shape) -> SpecBundle:
    if shape.kind == "train":
        return train_specs(cfg, shape)
    if shape.kind == "prefill":
        return prefill_specs(cfg, shape)
    return decode_specs(cfg, shape)


def params_specs(cfg: ModelConfig):
    return model_for(cfg).init_params(cfg, 0, device="meta")
