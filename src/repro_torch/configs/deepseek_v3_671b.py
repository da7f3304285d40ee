"""DeepSeek-V3-671B [moe]: MLA, 1 shared + 256 routed experts top-8, MTP
[arXiv:2412.19437; hf].

MLA's latent KV cache (kv_lora_rank 512 + 64 RoPE dims per token) is the
best case for the paged-memory technique (DESIGN.md §4).  Routing here is
softmax top-8 (DeepSeek's sigmoid+bias noted as a deviation in DESIGN.md).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="mla_moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,             # dense-layer FFN (first_k_dense)
    moe_d_ff=2048,          # per-routed-expert FFN
    vocab_size=129280,
    n_experts=256,
    experts_per_token=8,
    n_shared_experts=1,
    first_k_dense=3,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    mtp_depth=0,            # MTP module available; off for assigned shapes
    rope_theta=10000.0,
    act="silu",
    norm="rms",
)
