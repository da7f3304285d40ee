"""Chameleon-34B [vlm]: early-fusion decoder over a unified text+VQ-image
token vocabulary (65 536) [arXiv:2405.09818; unverified].

The VQ image tokenizer is a STUB: image tokens arrive as ordinary token ids
in the merged vocab (early fusion means the backbone is a plain decoder);
``input_specs()`` supplies token ids directly.  Chameleon's qk-norm is on.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="dense",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    qk_norm=True,           # chameleon stabilizes with qk layernorm
    rope_theta=10000.0,
    act="silu",
    norm="rms",
)
