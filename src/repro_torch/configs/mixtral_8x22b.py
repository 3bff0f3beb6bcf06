"""mixtral-8x22b — MoE 8 experts top-2 with sliding-window attention.

[arXiv:2401.04088; hf]  56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, window 4096. SWA makes it sub-quadratic → runs long_500k with a
ring-buffer KV cache of the window size. On a 16-way model axis 8 experts are
indivisible → in-expert TP instead of EP (see models/moe.py).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16_384,
    moe_d_ff=16_384,
    vocab_size=32_768,
    num_experts=8,
    experts_per_token=2,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    source="arXiv:2401.04088; hf",
)
