"""Qwen3-14B [dense]: qk_norm + GQA [hf:Qwen/Qwen3-8B; hf]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1000000.0,
    act="silu",
    norm="rms",
)
