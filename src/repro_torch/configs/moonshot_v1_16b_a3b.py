"""moonshot-v1-16b-a3b — fine-grained MoE (kimi/moonlight), 64e top-6.

[hf:moonshotai/Moonlight-16B-A3B; hf]  48L d_model=2048 16H (GQA kv=16 → MHA)
per-expert d_ff=1408 vocab=163840.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    moe_d_ff=1408,
    vocab_size=163_840,
    num_experts=64,
    experts_per_token=6,
    # fine-grained experts: dispatch one-hot work is 12·B·S·g·d, so a
    # 2048 group would double this arch's compute — use 512 (DESIGN.md §3)
    moe_group_size=512,
    rope_theta=50_000.0,
    source="hf:moonshotai/Moonlight-16B-A3B; hf",
)
