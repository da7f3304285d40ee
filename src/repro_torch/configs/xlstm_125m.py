"""xLSTM-125M [ssm]: sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

12 blocks, sLSTM at positions 5 and 11 (a 5:1 mLSTM:sLSTM mix), d_ff=0 —
the mLSTM blocks are pre-up-projection (internal 2x expansion), the sLSTM
block carries its own 4/3 post-up FFN.  Attention-free: long_500k RUNS
(fixed-size recurrent state; no KV pages at all — DESIGN.md §4).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="xlstm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    slstm_at=(5, 11),
    mlstm_proj_factor=2.0,
    slstm_proj_factor=1.3333333,
    norm="ln",
)
