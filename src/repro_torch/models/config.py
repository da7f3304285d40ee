"""Architecture configuration dataclass shared by all model families."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"        # dense | moe | mla_moe | hybrid | xlstm | encdec
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 512
    vocab_size: int = 256
    head_dim: int = 0            # 0 -> d_model // n_heads
    rope_theta: float = 10000.0
    qk_norm: bool = False        # qwen3 / chameleon style per-head norm
    sliding_window: int = 0      # 0 = full attention (SWA otherwise)
    norm: str = "rms"            # rms | ln
    act: str = "silu"            # silu (SwiGLU) | gelu (plain MLP)
    attn_bias: bool = False
    mlp_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    # ---- MoE ----
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0       # deepseek: first k layers are dense
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001

    # ---- MLA (DeepSeek-V3) ----
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    mtp_depth: int = 0           # multi-token prediction modules

    # ---- SSM (Mamba2) / hybrid (Zamba2) ----
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    attn_every: int = 0          # hybrid: shared attn block after every k SSM blocks

    # ---- xLSTM ----
    slstm_at: Tuple[int, ...] = ()
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 1.3333333

    # ---- encoder-decoder (Whisper) ----
    n_enc_layers: int = 0
    max_source_positions: int = 1500
    max_target_positions: int = 448

    # ---- serving ----
    kv_page_tokens: int = 256    # tokens per KV page (VMEM-friendly tile)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(1, self.n_heads))

    # ------------------------------------------------------------- helpers
    @property
    def is_encdec(self) -> bool:
        return self.family == "encdec"

    @property
    def is_attention_free(self) -> bool:
        return self.family == "xlstm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (DESIGN.md §4)."""
        return self.family in ("hybrid", "xlstm") or self.sliding_window > 0

    @property
    def group_size(self) -> int:
        return self.n_heads // max(1, self.n_kv_heads)

    def param_count(self) -> int:
        """Analytic parameter count (used for 6·N·D roofline cross-checks)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        hd = self.head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family in ("dense",):
            attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
                + (self.n_heads * hd) * d
            mlp = 3 * d * f if self.act == "silu" else 2 * d * f
            return emb + L * (attn + mlp + 2 * d) + d
        if self.family == "moe":
            attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
                + (self.n_heads * hd) * d
            expert = 3 * d * self.moe_d_ff
            return emb + L * (attn + self.n_experts * expert
                              + d * self.n_experts + 2 * d) + d
        if self.family == "mla_moe":
            r_q, r_kv = self.q_lora_rank, self.kv_lora_rank
            nope, rope, vh = self.qk_nope_head_dim, self.qk_rope_head_dim, self.v_head_dim
            H = self.n_heads
            attn = (d * r_q + r_q * H * (nope + rope)
                    + d * (r_kv + rope) + r_kv * H * (nope + vh)
                    + H * vh * d)
            expert = 3 * d * self.moe_d_ff
            dense_mlp = 3 * d * f
            moe_layers = L - self.first_k_dense
            return emb + L * (attn + 2 * d) \
                + self.first_k_dense * dense_mlp \
                + moe_layers * ((self.n_experts + self.n_shared_experts)
                                * expert + d * self.n_experts)
        if self.family == "hybrid":
            d_in = self.ssm_expand * d
            nh = d_in // self.ssm_head_dim
            mamba = (d * (2 * d_in + 2 * self.ssm_state + nh)   # in_proj
                     + self.ssm_conv * (d_in + 2 * self.ssm_state)
                     + nh + nh                                   # A_log, D
                     + d_in * d)                                 # out_proj
            attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
                + (self.n_heads * hd) * d
            shared = attn + 3 * d * self.d_ff + 2 * d
            return emb + L * (mamba + d) + shared + d
        if self.family == "xlstm":
            pf = self.mlstm_proj_factor
            d_in = int(d * pf)
            n_m = L - len(self.slstm_at)
            n_s = len(self.slstm_at)
            mlstm = d * 2 * d_in + 3 * d_in * d_in // 4 + d_in * d  # approx
            slstm = 4 * d * d + d * int(d * self.slstm_proj_factor) * 2
            return emb + n_m * mlstm + n_s * slstm + L * 2 * d + d
        if self.family == "encdec":
            attn = 4 * d * d
            mlp = 2 * d * f
            enc = self.n_enc_layers * (attn + mlp + 2 * d)
            dec = L * (2 * attn + mlp + 3 * d)
            return emb + enc + dec + d
        raise ValueError(self.family)

    def active_param_count(self) -> int:
        """Active (per-token) parameters — MoE activates top-k experts."""
        if self.family == "moe":
            total = self.param_count()
            inactive = (self.n_experts - self.experts_per_token) \
                * 3 * self.d_model * self.moe_d_ff * self.n_layers
            return total - inactive
        if self.family == "mla_moe":
            total = self.param_count()
            moe_layers = self.n_layers - self.first_k_dense
            inactive = (self.n_experts - self.experts_per_token) \
                * 3 * self.d_model * self.moe_d_ff * moe_layers
            return total - inactive
        return self.param_count()


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    base = dict(
        n_layers=min(cfg.n_layers, 2),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=128,
        sliding_window=min(cfg.sliding_window, 32) if cfg.sliding_window else 0,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        experts_per_token=min(cfg.experts_per_token, 2) if cfg.experts_per_token else 0,
        moe_d_ff=64 if cfg.moe_d_ff else 0,
        n_shared_experts=min(cfg.n_shared_experts, 1),
        first_k_dense=min(cfg.first_k_dense, 1),
        q_lora_rank=32 if cfg.q_lora_rank else 0,
        kv_lora_rank=16 if cfg.kv_lora_rank else 0,
        qk_nope_head_dim=16 if cfg.qk_nope_head_dim else 0,
        qk_rope_head_dim=8 if cfg.qk_rope_head_dim else 0,
        v_head_dim=16 if cfg.v_head_dim else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        attn_every=min(cfg.attn_every, 2) if cfg.attn_every else 0,
        slstm_at=(1,) if cfg.slstm_at else (),
        n_enc_layers=min(cfg.n_enc_layers, 2),
        max_source_positions=16 if cfg.is_encdec else cfg.max_source_positions,
        mtp_depth=0,
        kv_page_tokens=16,
        capacity_factor=2.0,   # dropless at smoke-test sizes (decode parity)
        dtype="float32",
    )
    if cfg.family == "hybrid":
        base["n_layers"] = 5   # 2 groups of 2 + tail, exercises shared attn
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
