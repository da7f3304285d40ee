"""The four assigned input-shape sets (seq_len x global_batch).

``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a
KV cache of seq_len), NOT ``train_step``.  ``long_500k`` requires
sub-quadratic attention: run only for SSM / hybrid / SWA archs
(DESIGN.md §4 documents the per-arch skips).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str           # "train" | "prefill" | "decode"


TRAIN_4K = Shape("train_4k", 4096, 256, "train")
PREFILL_32K = Shape("prefill_32k", 32768, 32, "prefill")
DECODE_32K = Shape("decode_32k", 32768, 128, "decode")
LONG_500K = Shape("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shapes_for(cfg) -> list:
    """Applicable shapes for an arch (documented skips in DESIGN.md §4)."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.sub_quadratic:
        out.append(LONG_500K)
    return out


def skip_reason(cfg, shape) -> str:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("pure full attention: 500k-token decode has no bounded "
                "resident set; skipped per assignment note")
    return ""
