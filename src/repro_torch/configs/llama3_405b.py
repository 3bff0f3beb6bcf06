"""llama3-405b — dense GQA decoder, 128k vocab. [arXiv:2407.21783; unverified]

126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256.
FSDP over (pod, data) is mandatory at this scale (see DESIGN.md §3).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16_384,
    num_heads=128,
    num_kv_heads=8,
    d_ff=53_248,
    vocab_size=128_256,
    rope_theta=500_000.0,
    source="arXiv:2407.21783; unverified",
)
