"""Zamba2-7B [hybrid]: Mamba2 backbone + shared attention block
[arXiv:2411.15242; unverified].

81 Mamba2 blocks; the single shared transformer block runs after every 6th
block (13 applications + 3-block tail).  Zamba2's per-application LoRA
deltas on the shared block are omitted (noted in DESIGN.md §2).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_every=6,
    rope_theta=10000.0,
    act="silu",
    norm="rms",
)
