"""Architecture registry of the port.

The port registers all ten architectures of the JAX package: the dense
attention stack (with or without qk-norm, tied or untied head, sliding
window), the mixture-of-experts FFN on it, the xLSTM stack (mLSTM +
sLSTM), the Mamba-2 + attention hybrid (jamba) and the two modality
frontends (llava, musicgen: a linear projection of precomputed features
before the tokens). The workload input specs of the JAX registry are
built from ``jax.ShapeDtypeStruct`` and are left out.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ModelConfig,
    RunConfig,
    ShapeConfig,
    shape_applicable,
)

_ARCH_MODULES = {
    "qwen3-1.7b": "qwen3_1_7b",
    "xlstm-1.3b": "xlstm_1_3b",
    "internlm2-1.8b": "internlm2_1_8b",
    "internlm2-20b": "internlm2_20b",
    "llama3-405b": "llama3_405b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "mixtral-8x22b": "mixtral_8x22b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "llava-next-34b": "llava_next_34b",
    "musicgen-medium": "musicgen_medium",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return get_config(name[: -len("-smoke")]).reduced()
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    cfg: ModelConfig = mod.CONFIG
    cfg.validate()
    return cfg
