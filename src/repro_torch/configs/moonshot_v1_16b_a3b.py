"""moonshot-v1-16b-a3b — a stand-in fine-grained MoE, 64e top-6.

Moonlight-16B-A3B's expert and vocabulary widths (per-expert d_ff=1408,
vocab=163840, d_model=2048, 16 heads) on the JAX package's MoE block: 48
layers of full multi-head attention (GQA kv=16), softmax top-6 routing with
capacity drops, no shared experts and no dense first layer. It is not
Moonlight: the real model (latent attention, 27 layers, sigmoid routing,
shared experts) is the port's ``moonlight-16b-a3b``. This preset is kept as
it is for the tests that hold the port to the JAX package.
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
