"""Architecture registry of the port.

The port registers all ten architectures of the JAX package (``ARCH_IDS``)
and presets of its own (``moonlight-16b-a3b``, latent attention): the dense
attention stack (with or without qk-norm, tied or untied head, sliding
window), the mixture-of-experts FFN on it, the xLSTM stack (mLSTM +
sLSTM), the Mamba-2 + attention hybrid (jamba) and the two modality
frontends (llava, musicgen: a linear projection of precomputed features
before the tokens). The workload input specs of the JAX registry are
given as ``meta`` tensors (the reference's are ``jax.ShapeDtypeStruct``s):
``input_specs`` and ``input_shardings`` for the dry-run's cells
(``all_cells``).
"""

from __future__ import annotations

import importlib

import torch

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

# presets of the port alone, with no twin in the JAX package: get_config
# finds them, ARCH_IDS (the architectures both packages hold) leaves them out
_PORT_MODULES = {
    "moonlight-16b-a3b": "moonlight_16b_a3b",
}


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return get_config(name[: -len("-smoke")]).reduced()
    module = _ARCH_MODULES.get(name) or _PORT_MODULES.get(name)
    if module is None:
        raise KeyError(f"unknown arch {name!r}; known: {sorted({**_ARCH_MODULES, **_PORT_MODULES})}")
    mod = importlib.import_module(f"repro_torch.configs.{module}")
    cfg: ModelConfig = mod.CONFIG
    cfg.validate()
    return cfg


def all_cells() -> list[tuple[str, str]]:
    """Every applicable (arch, shape) assignment cell (33 total)."""
    cells = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            if shape_applicable(cfg, shape):
                cells.append((arch, shape.name))
    return cells


# ---------------------------------------------------------------------------
# Input specs: ``meta`` tensor stand-ins for every model input
# ---------------------------------------------------------------------------


def prefix_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Stub modality-frontend length (frames/patches) within seq_len."""
    if not cfg.frontend or shape.kind == "decode":
        return 0
    from repro_torch.models.model import DEFAULT_PREFIX_LEN

    return min(DEFAULT_PREFIX_LEN, shape.seq_len // 2)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """``meta`` tensors for the step function's data inputs.

    train   → tokens, labels, loss mask (+ frontend features)
    prefill → tokens (+ frontend features)
    decode  → tokens (B, 1); the KV/state cache is a separate argument
              (``launch/steps.py::cache_shapes``).

    Token ids are int64, the index type the port's embedding takes (the
    reference's are int32).
    """
    from repro_torch.models.model import FRONTEND_FEATURE_DIM

    b, s = shape.global_batch, shape.seq_len
    f = prefix_len(cfg, shape)

    def spec(dims, dtype):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind == "train":
        specs = {"tokens": spec((b, s - f), torch.long), "labels": spec((b, s), torch.long),
                 "mask": spec((b, s), torch.float32)}
    elif shape.kind == "prefill":
        specs = {"tokens": spec((b, s - f), torch.long)}
    elif shape.kind == "decode":
        specs = {"tokens": spec((b, 1), torch.long)}
    else:
        raise ValueError(shape.kind)
    if f:
        specs["prefix_features"] = spec((b, f, FRONTEND_FEATURE_DIM[cfg.frontend]), torch.bfloat16)
    return specs


def input_shardings(cfg: ModelConfig, shape: ShapeConfig, rules) -> dict:
    """Logical shardings matching input_specs (batch over DP axes)."""
    out = {}
    for k, v in input_specs(cfg, shape).items():
        out[k] = rules.spec(("batch",) + (None,) * (v.dim() - 1), v.shape)
    return out
