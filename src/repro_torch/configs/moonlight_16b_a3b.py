"""moonlight-16b-a3b — Moonlight-16B-A3B (DeepSeek-V3 architecture) at its
published widths.

[hf:moonshotai/Moonlight-16B-A3B config.json, model_type deepseek_v3]
27 layers of width 2048, vocabulary 163840, untied head. Attention is
multi-head latent attention: 16 heads, q one projection (``q_lora_rank``
null), a k/v latent of 512 normed and cached with one shared RoPE key of 64
a token (576 values a token and layer), q and k heads of 128 + 64, v heads
of 128, ``rope_theta`` 50000. Layer 0 has a dense SwiGLU of 11264
(``first_k_dense_replace`` 1); layers 1-26 route each token to 6 of 64
experts of 1408 beside 2 shared experts (one SwiGLU of 2816): sigmoid
scores, selection on the scores plus a per-expert correction bias
(``noaux_tc`` with one group), gates the selected scores renormalised and
times 2.446, dropless. The port only: the JAX package has no MLA.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonlight-16b-a3b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=192,  # the q and k heads: qk_nope_head_dim + qk_rope_head_dim
    d_ff=11264,
    moe_d_ff=1408,
    vocab_size=163_840,
    num_experts=64,
    experts_per_token=6,
    first_dense_layers=1,
    shared_d_ff=2 * 1408,
    routed_scale=2.446,
    moe_dropless=True,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    rope_theta=50_000.0,
    source="hf:moonshotai/Moonlight-16B-A3B",
)
