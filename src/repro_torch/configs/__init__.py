"""Architecture registry of the port.

The JAX package knows ten architectures; the port runs the dense attention
stack (with or without qk-norm, tied or untied head, sliding window), the
mixture-of-experts FFN on it, and the xLSTM stack (mLSTM + sLSTM), so
those seven are registered here. The Mamba-2 hybrid and the two modality
frontends raise a "not ported" error naming the arch. The workload input
specs of the JAX registry are built from ``jax.ShapeDtypeStruct`` and are
left out.
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
}

# known to the JAX package, not yet to the port: the Mamba-2 block (jamba)
# and the modality frontends (llava, musicgen)
_NOT_PORTED = (
    "musicgen-medium",
    "jamba-1.5-large-398b",
    "llava-next-34b",
)

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return get_config(name[: -len("-smoke")]).reduced()
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported to repro_torch yet; ported: {sorted(_ARCH_MODULES)}"
        )
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    cfg: ModelConfig = mod.CONFIG
    cfg.validate()
    return cfg
