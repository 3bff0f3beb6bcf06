"""llava-next-34b — VLM; transformer BACKBONE only per the assignment.

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]  60L d_model=7168 56H
(GQA kv=8) d_ff=20480 vocab=64000. The anyres tiling vision tower is a STUB:
the caller passes precomputed patch embeddings (SigLIP-dim features,
``prefix_features``) that a learned linear frontend projects into the stream.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20_480,
    vocab_size=64_000,
    rope_theta=5_000_000.0,
    frontend="vision_patches",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
)
