"""musicgen-medium — decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284; hf]  48L d_model=1536 24H (GQA kv=24 → MHA) d_ff=6144
vocab=2048. The EnCodec modality frontend is a STUB per the assignment:
the caller passes precomputed frame embeddings (``prefix_features``).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    rope_theta=10_000.0,
    frontend="audio_frames",
    source="arXiv:2306.05284; hf",
)
