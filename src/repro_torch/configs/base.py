"""Configuration system for HetJAX.

Two config families:

* :class:`ModelConfig` — architecture definition, expressive enough to cover
  every assigned architecture family (dense GQA, MoE, hybrid Mamba+attn,
  xLSTM, VLM/audio backbones with stub frontends).
* :class:`ShapeConfig` — an (input-shape × step-kind) workload cell from the
  assignment: ``train_4k``, ``prefill_32k``, ``decode_32k``, ``long_500k``.

Everything downstream (models, sharding, dry-run, roofline) is driven by
these two dataclasses plus :class:`RunConfig` knobs.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional


# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description.

    The per-layer block pattern is derived, not stored: ``layer_kind(i)``
    returns one of ``attn | mamba | mlstm | slstm`` and ``layer_is_moe(i)``
    says whether layer *i*'s FFN is a routed MoE. All patterns used by the
    assigned archs are periodic, which lets the model stack be expressed as
    ``lax.scan`` over a fixed "period" of blocks (critical to keep compiled
    HLO size independent of depth for 126-layer models).
    """

    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 → d_model // num_heads

    # --- attention flavour -------------------------------------------------
    qk_norm: bool = False
    sliding_window: int = 0  # 0 → full causal attention
    rope_theta: float = 10_000.0

    # --- mixture of experts -------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0  # per-expert hidden dim (0 → use d_ff)
    moe_every: int = 1  # routed FFN on layers with i % moe_every == moe_every-1
    moe_capacity_factor: float = 1.25
    moe_eval_capacity_factor: float = 2.0  # inference: fewer/no drops
    moe_group_size: int = 2048  # GShard-style dispatch group (sequence chunks)
    # DeepSeek-V3-style MoE (the defaults keep the softmax, capacity-bounded
    # path above): leading layers with a dense FFN of ``d_ff``, shared
    # experts (one SwiGLU of their total width) beside the routed ones, and
    # ``moe_dropless``: DeepSeek-V3 routing without capacity or dispatch
    # groups (sigmoid scores, a per-expert correction bias in the selection
    # but not in the gates, the gates renormalised and times ``routed_scale``)
    first_dense_layers: int = 0
    shared_d_ff: int = 0  # 0 → no shared experts
    routed_scale: float = 1.0  # dropless only
    moe_dropless: bool = False

    # --- multi-head latent attention (MLA, DeepSeek-V2/V3) -------------------
    # kv_lora_rank > 0: k and v come from a normed latent of that width,
    # cached with one shared RoPE key of qk_rope_head_dim per token; q and k
    # heads are qk_nope_head_dim + qk_rope_head_dim wide, v heads v_head_dim
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- hybrid / SSM block pattern ----------------------------------------
    attn_every: int = 1  # 1 → every layer is attention; k → attn at i%k==attn_offset
    attn_offset: int = 0
    ssm_kind: str = ""  # "" | "mamba2" | "xlstm"
    slstm_every: int = 0  # xLSTM: sLSTM at i % slstm_every == slstm_every - 1
    d_state: int = 64  # SSM state size per head
    ssm_expand: int = 2  # mamba inner expansion
    conv_width: int = 4  # mamba local conv width

    # --- modality frontends (stubs per assignment) --------------------------
    frontend: str = ""  # "" | "audio_frames" | "vision_patches"

    # --- numerics ------------------------------------------------------------
    norm_eps: float = 1e-5
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # --- citation/bookkeeping -------------------------------------------------
    source: str = ""

    # ------------------------------------------------------------------ helpers
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        assert self.num_heads % self.num_kv_heads == 0
        return self.num_heads // self.num_kv_heads

    def layer_kind(self, i: int) -> str:
        """Block kind for layer ``i``."""
        if self.ssm_kind == "xlstm":
            if self.slstm_every and i % self.slstm_every == self.slstm_every - 1:
                return "slstm"
            return "mlstm"
        if self.attn_every > 1:  # hybrid: attention every k-th layer, SSM rest
            return "attn" if i % self.attn_every == self.attn_offset else "mamba"
        return "attn"

    def layer_is_moe(self, i: int) -> bool:
        if not self.num_experts or i < self.first_dense_layers:
            return False
        return i % self.moe_every == self.moe_every - 1

    def layer_has_ffn(self, i: int) -> bool:
        """xLSTM blocks embed their projections; no separate FFN when d_ff==0."""
        if self.d_ff == 0 and not self.layer_is_moe(i):
            return False
        return self.layer_kind(i) in ("attn", "mamba", "mlstm", "slstm")

    @property
    def period(self) -> int:
        """Length of the repeating block pattern (scan body size)."""
        p = 1
        if self.attn_every > 1:
            p = math.lcm(p, self.attn_every)
        if self.slstm_every:
            p = math.lcm(p, self.slstm_every)
        if self.num_experts and self.moe_every > 1:
            p = math.lcm(p, self.moe_every)
        assert self.num_layers % p == 0, (self.name, self.num_layers, p)
        return p

    @property
    def num_periods(self) -> int:
        return self.num_layers // self.period

    @property
    def ffn_dim(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def d_inner(self) -> int:
        """Mamba inner width."""
        return self.ssm_expand * self.d_model

    # --------------------------------------------------------------- long-ctx
    @property
    def subquadratic(self) -> bool:
        """True when a 500k-token decode is feasible (state/window-bounded)."""
        return bool(self.ssm_kind) or self.attn_every > 1 or self.sliding_window > 0

    # ----------------------------------------------------------- param counts
    def count_params(self) -> int:
        """Total parameter count (embedding included)."""
        return _count_params(self, active_only=False)

    def count_active_params(self) -> int:
        """Parameters touched per token (MoE: only routed experts_per_token)."""
        return _count_params(self, active_only=True)

    def validate(self) -> None:
        assert self.d_model % self.num_heads == 0 or self.head_dim
        assert self.num_heads % self.num_kv_heads == 0
        _ = self.period  # divisibility check

    def reduced(self, **overrides) -> "ModelConfig":
        """A smoke-test-sized sibling preserving the block pattern."""
        small = dict(
            num_layers=self.period * 2,
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, 4 // max(1, self.q_per_kv)),
            head_dim=16,
            d_ff=0 if self.d_ff == 0 else 128,
            vocab_size=256,
            moe_d_ff=64 if self.num_experts else 0,
            num_experts=min(self.num_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            d_state=16,
            moe_group_size=64,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
            name=self.name + "-smoke",
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


def _attn_params(cfg: ModelConfig) -> int:
    if cfg.kv_lora_rank:  # MLA: wq, wkv_a, kv_norm, wkv_b, wo
        h, r = cfg.num_heads, cfg.kv_lora_rank
        qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        return (cfg.d_model * h * qk + cfg.d_model * (r + cfg.qk_rope_head_dim) + r
                + r * h * (cfg.qk_nope_head_dim + cfg.v_head_dim) + h * cfg.v_head_dim * cfg.d_model)
    hd = cfg.head_dim_
    q = cfg.d_model * cfg.num_heads * hd
    kv = 2 * cfg.d_model * cfg.num_kv_heads * hd
    o = cfg.num_heads * hd * cfg.d_model
    qknorm = 2 * hd if cfg.qk_norm else 0
    return q + kv + o + qknorm


def _ffn_params(cfg: ModelConfig, d_ff: int) -> int:
    return 3 * cfg.d_model * d_ff  # SwiGLU: gate, up, down


def _mamba_params(cfg: ModelConfig) -> int:
    di = cfg.d_inner
    heads = max(1, di // 128)  # mamba2 heads of size 128
    in_proj = cfg.d_model * (2 * di + 2 * cfg.d_state * heads + heads)
    conv = cfg.conv_width * (di + 2 * cfg.d_state * heads)
    out = di * cfg.d_model
    extras = 2 * heads + di  # A_log, D, norm
    return in_proj + conv + out + extras


def _mlstm_params(cfg: ModelConfig) -> int:
    hd = cfg.head_dim_
    H = cfg.num_heads
    di = H * hd
    qkv = 3 * cfg.d_model * di
    gates = 2 * cfg.d_model * H + 2 * H
    up_gate = 2 * cfg.d_model * 2 * cfg.d_model  # projection block (expand 2)
    down = 2 * cfg.d_model * cfg.d_model
    out = di * cfg.d_model
    return qkv + gates + out + up_gate + down


def _slstm_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    return 4 * (d * d + d * d + d) + 2 * d * (4 * d) // 3 * 3  # rec + inp gates + ffn-ish


def _count_params(cfg: ModelConfig, active_only: bool) -> int:
    total = cfg.vocab_size * cfg.d_model  # embed
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * cfg.d_model
    total += cfg.d_model  # final norm
    for i in range(cfg.num_layers):
        kind = cfg.layer_kind(i)
        total += cfg.d_model  # pre-norm
        if kind == "attn":
            total += _attn_params(cfg)
        elif kind == "mamba":
            total += _mamba_params(cfg)
        elif kind == "mlstm":
            total += _mlstm_params(cfg)
        elif kind == "slstm":
            total += _slstm_params(cfg)
        if cfg.layer_has_ffn(i):
            total += cfg.d_model  # ffn pre-norm
            if cfg.layer_is_moe(i):
                e = cfg.experts_per_token if active_only else cfg.num_experts
                total += e * _ffn_params(cfg, cfg.ffn_dim)
                total += cfg.d_model * cfg.num_experts  # router
                total += cfg.num_experts if cfg.moe_dropless else 0  # correction bias
                total += _ffn_params(cfg, cfg.shared_d_ff)
            elif cfg.d_ff:
                total += _ffn_params(cfg, cfg.d_ff)
    return total


# ---------------------------------------------------------------------------
# Workload shapes (assignment cells)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens_per_step(self) -> int:
        if self.kind == "decode":
            return self.global_batch  # one new token per sequence
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def shape_applicable(model: ModelConfig, shape: ShapeConfig) -> bool:
    """long_500k needs sub-quadratic attention (see DESIGN.md §5)."""
    if shape.name == "long_500k":
        return model.subquadratic
    return True


# ---------------------------------------------------------------------------
# Run configuration (training/serving knobs orthogonal to the architecture)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RunConfig:
    """Everything the launcher needs beyond the architecture itself."""

    # distribution
    mesh_shape: tuple[int, ...] = (16, 16)
    mesh_axes: tuple[str, ...] = ("data", "model")
    fsdp: bool = True  # ZeRO-3 style parameter sharding over the data axes
    sequence_parallel: bool = True  # shard long activations over `model`
    remat: str = "full"  # none | dots | full
    # gradient accumulation inside the compiled step: the global batch is
    # split into this many sequential microbatches (activation memory ÷ k)
    grad_accum_steps: int = 1
    # pad attention heads (activation-level, function-preserving) up to a
    # multiple of this so indivisible head counts (56, 24) still shard over
    # the 16-way model axis; 0 = off
    pad_attention_heads_to: int = 0

    # attention implementation: xla | chunked | pallas | pallas_interpret
    attention_impl: str = "chunked"
    # decode-step attention (the serving hot loop, one token vs KV cache):
    #   einsum           — masked-softmax einsum over the full cache; the
    #                      CPU/reference fallback and the default
    #   kernel           — Pallas flash-decode (kernels/decode_attention.py),
    #                      one streaming pass over K/V with the per-slot
    #                      ring/partial-fill valid mask; TPU only
    #   kernel_interpret — same kernel in interpret mode (CPU parity tests)
    decode_attention_impl: str = "einsum"
    attention_chunk: int = 1024
    ssd_chunk: int = 256  # SSD/mLSTM chunk length
    # unroll inner (attention/ssd) scans — used by dry-run cost probes so
    # HloCostAnalysis counts every loop iteration (see roofline/extract.py)
    scan_unroll: bool = False

    # optimizer
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    optimizer_dtype: str = "float32"  # moments dtype; bf16 halves opt memory
    warmup_steps: int = 100
    total_steps: int = 1000
    z_loss: float = 1e-4
    moe_aux_loss: float = 1e-2

    # gradient compression (beyond-paper distributed-optimization trick)
    grad_compression: str = "none"  # none | int8_ef

    # heterogeneity-aware runtime (the paper's technique)
    het_schedule: bool = True
    replication_factor: int = 3
    heartbeat_interval_s: float = 3.0  # paper §IV.c.ii
    dead_after_s: float = 600.0  # paper: 10 minutes
    grain_target_s: float = 35.0  # paper §IV.b.i: 30–40 s rule midpoint
    speculation: str = "late"  # off | naive | late

    # checkpointing
    checkpoint_every: int = 100
    checkpoint_redundancy: str = "replicate"  # replicate | stripe
    checkpoint_async: bool = True

    @property
    def data_axes(self) -> tuple[str, ...]:
        return tuple(a for a in self.mesh_axes if a in ("pod", "data"))

    @property
    def model_axis(self) -> str:
        return "model"
