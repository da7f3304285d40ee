"""Whisper-medium [audio]: encoder-decoder with a STUBBED conv frontend
[arXiv:2212.04356; unverified].

``input_specs()`` provides precomputed log-mel frame embeddings
(B, 1500, d_model); the decoder is the transformer backbone under test.
Cross-attention KV is computed once and pinned; decoder self-attention KV
is paged (DESIGN.md §4).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,            # decoder layers
    n_enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    max_source_positions=1500,
    max_target_positions=448,
    act="gelu",
    norm="ln",
    tie_embeddings=True,
)
