"""qwen3-1.7b — dense GQA decoder with per-head qk RMSNorm. [hf:Qwen/Qwen3-1.7B]

28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936, head_dim=128.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="hf:Qwen/Qwen3-1.7B",
)
