"""StarCoder2-3B [dense]: GQA + RoPE, LayerNorm + GELU + biases
[arXiv:2402.19173; hf]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    rope_theta=999999.4,
    act="gelu",
    norm="ln",
    attn_bias=True,
    mlp_bias=True,
)
