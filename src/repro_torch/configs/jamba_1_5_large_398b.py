"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7 with MoE 16e top-2.

[arXiv:2403.19887; hf]  72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536. Attention at layer i % 8 == 3 (one attn per 8-layer period),
MoE FFN every other layer. Sub-quadratic: runs long_500k (Mamba state O(1);
the 9 attention layers keep full KV).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24_576,
    vocab_size=65_536,
    num_experts=16,
    experts_per_token=2,
    moe_every=2,
    attn_every=8,
    attn_offset=3,
    ssm_kind="mamba2",
    d_state=64,
    ssm_expand=2,
    rope_theta=10_000.0,
    source="arXiv:2403.19887; hf",
)
