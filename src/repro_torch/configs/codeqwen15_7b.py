"""CodeQwen1.5-7B [dense]: qwen1.5 architecture [hf:Qwen/CodeQwen1.5-7B; hf]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,          # MHA (GQA kv=32)
    d_ff=13440,
    vocab_size=92416,
    rope_theta=1000000.0,   # qwen1.5 long-context base
    act="silu",
    norm="rms",
    attn_bias=True,         # qwen1.5 uses qkv bias
)
