"""H2O-Danube-1.8B [dense]: llama+mistral mix with sliding-window attention
[arXiv:2401.16818; hf].  SWA makes it sub-quadratic -> long_500k RUNS with a
window-bounded resident KV set (DESIGN.md §4)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    sliding_window=4096,
    rope_theta=10000.0,
    act="silu",
    norm="rms",
)
