"""Mixtral-8x7B [moe]: 8 experts top-2, SWA [arXiv:2401.04088; hf]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,             # per-expert FFN width
    moe_d_ff=14336,
    vocab_size=32000,
    n_experts=8,
    experts_per_token=2,
    sliding_window=4096,
    rope_theta=1000000.0,
    act="silu",
    norm="rms",
)
