"""Plain PyTorch reference of Moonlight-16B-A3B, the DeepSeek-V3
architecture that the configuration ``moonlight-16b-a3b.json`` describes,
and the weights both the program and this reference read.

It follows the equations of the published ``modeling_deepseek.py`` for the
keys the file holds: pre-norm blocks with RMSNorm; multi-head latent
attention with q as one projection (``q_lora_rank`` null): q of
``qk_nope_head_dim + qk_rope_head_dim`` a head, a latent of
``kv_lora_rank`` RMS-normed and expanded into each head's no-RoPE key and
its value, one RoPE key a token shared by the heads, softmax scaled by
``(qk_nope_head_dim + qk_rope_head_dim) ** -0.5``; the first
``first_k_dense_replace`` layers with a SwiGLU FFN of
``intermediate_size``, the rest with ``n_routed_experts`` SwiGLU experts
of ``moe_intermediate_size``, ``num_experts_per_tok`` a token and no
capacity (each token's experts computed, none dropped), beside
``n_shared_experts`` shared experts (one SwiGLU of their total width).
The router (``noaux_tc``, ``n_group`` = ``topk_group`` = 1) takes the
sigmoid of its product, chooses on the scores plus the per-expert
correction bias, and weighs the chosen experts by their scores without the
bias, renormalised (``norm_topk_prob``) and times
``routed_scaling_factor``. Attention is computed the plain way, every
head's keys and values expanded, for every position, not absorbed.

Departures, each a convention shared with the program that changes no
equation of a model whose weights are random: RMSNorm scales are stored as
``g`` and applied as ``1 + g`` (zero at the start, a scale of 1, as the
checkpoint's ones); RoPE rotates the two halves of each q and k RoPE part
together, where the published code first de-interleaves them (a fixed
permutation of the seeded q and k RoPE columns); the router's product is
float32, as the published gate computes it.

The seeded weights route on the token's identity (:func:`_route_by_token`):
the routers read only a channel of the residual stream that holds the
embedding alone, so that a router's top-k margins are wider than bf16
round-off, as a trained router's are, and the bf16 program, the fp8
control and this reference choose the same experts. Random routers without
margins do not: a bf16 round-off tips a near-tie of a token's 6th and 7th
experts, and later layers route off the moved state, so the widest gap of
a sound bf16 run reached the control's.

Everything is computed in float32 with TF32 off (``fp32()``), in blocks of
query rows and one layer at a time, its weights widened from the seeded
bf16 (exactly) while it runs, so that it fits on the card beside the
seeded weights alone: the caller frees the program's state first. Only the
positions that predict served tokens go through the head.
``quant="fp8"`` is the control: every weight product takes its inputs
rounded to float8 e4m3, scaled by rows and output columns, as
``transformer_ref`` rounds them.

As every reference of a configuration does, it states the contract between
its file and the program: ``program_sizes``, ``leaf_paths`` and
``tiny_cut``. It imports nothing of the program and no JAX.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path

import torch
import torch.nn.functional as F

from benchlib.spec import load_module

# the shared blocks of the dense reference: float32 switch, rounding, RMSNorm, RoPE, weight tree
_T = load_module(Path(__file__).resolve().parent / "transformer_ref.py")
fp32, mm, rms, rope, _put, CHUNK = _T.fp32, _T.mm, _T.rms, _T.rope, _T._put, _T.CHUNK

# The routers read a token-identity channel (see make_params): its width at
# most, the magnitude of the routers' weights on it, and the correction
# bias's step (the bias is a seeded permutation of 0 .. E-1 times the step)
ROUTE_DIMS = 64
ROUTE_SCALE = 2.0 ** -7
BIAS_STEP = 2.0 ** -20


@dataclass(frozen=True)
class Dims:
    D: int
    H: int
    L: int
    V: int
    F: int  # the dense layers' FFN width
    FE: int  # an expert's width
    FS: int  # the shared experts' total width
    E: int
    K: int  # experts a token
    dense: int  # leading dense layers
    R: int  # latent width
    N: int  # q and k width without RoPE
    P: int  # RoPE width
    VH: int  # v width
    eps: float
    theta: float
    scale: float  # routed_scaling_factor
    tied: bool


# the published settings this reference implements; a file that states another is refused
FIXED = {"q_lora_rank": None, "scoring_func": "sigmoid", "topk_method": "noaux_tc", "n_group": 1,
         "topk_group": 1, "norm_topk_prob": True, "moe_layer_freq": 1, "hidden_act": "silu",
         "attention_bias": False}


def dims(cfg: dict) -> Dims:
    """The sizes of a configuration file, under the keys of its source."""
    for key, want in FIXED.items():
        if cfg.get(key, want) != want:
            raise ValueError(f"moonlight_ref implements {key}={want!r}, the file states {cfg[key]!r}")
    if cfg.get("rope_scaling"):
        raise ValueError("moonlight_ref implements no rope_scaling")
    return Dims(
        D=cfg["hidden_size"], H=cfg["num_attention_heads"], L=cfg["num_hidden_layers"], V=cfg["vocab_size"],
        F=cfg["intermediate_size"], FE=cfg["moe_intermediate_size"],
        FS=cfg["n_shared_experts"] * cfg["moe_intermediate_size"], E=cfg["n_routed_experts"],
        K=cfg["num_experts_per_tok"], dense=cfg["first_k_dense_replace"], R=cfg["kv_lora_rank"],
        N=cfg["qk_nope_head_dim"], P=cfg["qk_rope_head_dim"], VH=cfg["v_head_dim"], eps=cfg["rms_norm_eps"],
        theta=float(cfg["rope_theta"]), scale=float(cfg["routed_scaling_factor"]),
        tied=bool(cfg["tie_word_embeddings"]),
    )


def program_sizes(cfg: dict) -> dict:
    """The attributes of the program's ``ModelConfig`` that a configuration
    file implies, each with its value: what the program built from the file
    has to hold."""
    d = dims(cfg)
    return {"num_layers": d.L, "d_model": d.D, "num_heads": d.H, "num_kv_heads": cfg["num_key_value_heads"],
            "head_dim_": d.N + d.P, "vocab_size": d.V, "tie_embeddings": d.tied, "norm_eps": d.eps,
            "rope_theta": d.theta, "qk_norm": False, "sliding_window": 0, "d_ff": d.F, "moe_d_ff": d.FE,
            "num_experts": d.E, "experts_per_token": d.K, "moe_every": 1, "first_dense_layers": d.dense,
            "shared_d_ff": d.FS, "routed_scale": d.scale, "moe_dropless": True, "kv_lora_rank": d.R,
            "qk_nope_head_dim": d.N, "qk_rope_head_dim": d.P, "v_head_dim": d.VH}


def tiny_cut() -> tuple[dict, dict]:
    """A cut that the CPU runs in seconds: one dense layer and two expert
    layers 64 wide, 8 experts with 2 a token, the latent 8 times and the
    no-RoPE width twice the RoPE width (as 512, 128 and 64), a vocabulary
    of 256: the file's keys and the program's overrides."""
    return ({"num_hidden_layers": 3, "hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 4,
             "intermediate_size": 128, "moe_intermediate_size": 32, "n_routed_experts": 8,
             "num_experts_per_tok": 2, "kv_lora_rank": 32, "qk_nope_head_dim": 8, "qk_rope_head_dim": 4,
             "v_head_dim": 8, "vocab_size": 256},
            {"num_layers": 3, "d_model": 64, "num_heads": 4, "num_kv_heads": 4, "head_dim": 12, "d_ff": 128,
             "moe_d_ff": 32, "shared_d_ff": 64, "num_experts": 8, "experts_per_token": 2, "kv_lora_rank": 32,
             "qk_nope_head_dim": 8, "qk_rope_head_dim": 4, "v_head_dim": 8, "vocab_size": 256})


# ---------------------------------------------------------------------------
# Weights: made from the seed on the device, in a few large calls
# ---------------------------------------------------------------------------


def _layer_leaves(d: Dims, i: int) -> list[tuple[tuple[str, ...], tuple[int, ...], str]]:
    """(path inside layer ``i``, shape, kind) of its weights. A kind's
    leaves share an initial scale."""
    out = [(("norm",), (d.D,), "norm"),
           (("attn", "wq"), (d.D, d.H, d.N + d.P), "in"), (("attn", "wkv_a"), (d.D, d.R + d.P), "in"),
           (("attn", "kv_norm"), (d.R,), "norm"), (("attn", "wkv_b"), (d.R, d.H, d.N + d.VH), "latent"),
           (("attn", "wo"), (d.H, d.VH, d.D), "attn_out"), (("ffn_norm",), (d.D,), "norm")]
    if i < d.dense:
        return out + [(("ffn", "gate"), (d.D, d.F), "in"), (("ffn", "up"), (d.D, d.F), "in"),
                      (("ffn", "down"), (d.F, d.D), "ffn_out")]
    return out + [(("moe", "router"), (d.D, d.E), "in"), (("moe", "gate"), (d.E, d.D, d.FE), "in"),
                  (("moe", "up"), (d.E, d.D, d.FE), "in"), (("moe", "down"), (d.E, d.FE, d.D), "expert_out"),
                  (("moe", "bias"), (d.E,), "bias"), (("moe", "shared", "gate"), (d.D, d.FS), "in"),
                  (("moe", "shared", "up"), (d.D, d.FS), "in"), (("moe", "shared", "down"), (d.FS, d.D), "shared_out")]


def _scale(d: Dims, kind: str) -> float:
    """Initial standard deviation of a kind: 1/sqrt(fan-in), 0.02 for the
    embedding; norms start at zero (a scale of 1); the correction bias is
    set by :func:`_route_by_token`."""
    return {"in": d.D ** -0.5, "latent": d.R ** -0.5, "attn_out": (d.H * d.VH) ** -0.5, "ffn_out": d.F ** -0.5,
            "expert_out": d.FE ** -0.5, "shared_out": d.FS ** -0.5, "bias": 0.0, "embed": 0.02,
            "head": d.D ** -0.5, "norm": 0.0}[kind]


def route_dims(d: Dims) -> int:
    """The width of the token-identity channel: :data:`ROUTE_DIMS`, at most
    a quarter of the model's width."""
    return min(ROUTE_DIMS, d.D // 4)


@torch.no_grad()
def _route_by_token(tree: dict, d: Dims, gen: torch.Generator) -> None:
    """Give the routers margins wider than bf16 round-off, as a trained
    router's are, by routing on the token's identity (which a trained MoE's
    routing mostly follows: Xue et al. 2024, OpenMoE, "context-independent
    specialization"). The first :func:`route_dims` dims of the residual
    stream form a channel that holds the token's embedding alone: there
    the embedding is a seeded sign (a value of 1), no layer writes (the
    rows of every output projection are zero) and the routers alone read
    (their weights a seeded sign times :data:`ROUTE_SCALE`, zero on the
    other dims). A router's product is then a whole number n of matching
    signs times one positive factor, exact in bf16 and fp32 alike, so
    experts of different n are ordered by n, and experts of equal n by the
    correction bias (a seeded permutation times :data:`BIAS_STEP`, far
    below a step of n, so that it chooses among equals and nothing
    more)."""
    m, dev = route_dims(d), tree["embed"].device

    def sign(*shape):
        return (torch.randint(0, 2, shape, generator=gen, device=dev) * 2 - 1).to(tree["embed"].dtype)

    tree["embed"][:, :m] = sign(d.V, m)
    for i, layer in enumerate(tree["layers"]):
        layer["attn"]["wo"][..., :m] = 0
        if i < d.dense:
            layer["ffn"]["down"][:, :m] = 0
            continue
        w = layer["moe"]
        w["down"][..., :m] = 0
        w["shared"]["down"][:, :m] = 0
        w["router"].zero_()
        w["router"][:m] = sign(m, d.E) * ROUTE_SCALE
        w["bias"].copy_(torch.randperm(d.E, generator=gen, device=dev) * BIAS_STEP)


def leaf_paths(d: Dims) -> list[tuple[tuple, tuple[int, ...], str]]:
    """Every weight: (path in the tree, shape, kind), in the tree's order."""
    out = [(("embed",), (d.V, d.D), "embed")]
    for i in range(d.L):
        out += [(("layers", i) + p, s, kind) for p, s, kind in _layer_leaves(d, i)]
    out.append((("final_norm",), (d.D,), "norm"))
    if not d.tied:
        out.append((("lm_head",), (d.D, d.V), "head"))
    return out


def make_params(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The weights of ``cfg`` from ``seed``, on ``device`` in ``dtype``, made
    as ``transformer_ref.make_params`` makes them: one buffer, each kind's
    leaves side by side in it, normal numbers from a ``torch.Generator`` on
    the device in calls of :data:`CHUNK` elements, scaled a kind at a time;
    then the routing channel (:func:`_route_by_token`), from the same
    generator. The same seed, device and dtype give the same weights."""
    d = dims(cfg)
    leaves = leaf_paths(d)
    kinds = sorted({kind for _, _, kind in leaves})
    sizes = {kind: sum(math.prod(s) for _, s, k in leaves if k == kind) for kind in kinds}
    flat = torch.empty(sum(sizes.values()), dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    start, offset = {}, 0
    for kind in kinds:
        start[kind] = offset
        seg = flat[offset:offset + sizes[kind]]
        std = _scale(d, kind)
        if std == 0.0:
            seg.zero_()
        else:
            for a in range(0, seg.numel(), CHUNK):
                part = seg[a:a + CHUNK]
                part.copy_(torch.randn(part.numel(), generator=gen, device=device, dtype=torch.float32).mul_(std))
        offset += sizes[kind]
    tree: dict = {}
    for path, shape, kind in leaves:
        n = math.prod(shape)
        _put(tree, path, flat[start[kind]:start[kind] + n].view(shape))
        start[kind] += n
    _route_by_token(tree, d, gen)
    return tree


def leaves_of(tree: dict, d: Dims) -> list[tuple[str, torch.Tensor]]:
    """(name, tensor) of every weight, in :func:`leaf_paths` order."""
    out = []
    for path, _, _ in leaf_paths(d):
        node = tree
        for key in path:
            node = node[key]
        out.append(("/".join(str(p) for p in path), node))
    return out


# ---------------------------------------------------------------------------
# The blocks, in float32
# ---------------------------------------------------------------------------


def attention(d: Dims, w: dict, x: torch.Tensor, quant=None, q_block: int = 1024) -> torch.Tensor:
    """Causal MLA of x (B, S, D) -> (B, S, D), not absorbed: each head's key
    and value expanded from the normed latent, the RoPE key shared by the
    heads; softmax over the keys in float32, ``q_block`` rows at a time."""
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device)
    q = mm(x, w["wq"].reshape(d.D, -1), quant).view(b, s, d.H, d.N + d.P)
    kv = mm(x, w["wkv_a"], quant)
    c = rms(kv[..., :d.R], w["kv_norm"], d.eps)
    k_pe = rope(kv[..., None, d.R:], pos, d.theta)  # (B, S, 1, P)
    kvb = mm(c, w["wkv_b"].reshape(d.R, -1), quant).view(b, s, d.H, d.N + d.VH)
    q = torch.cat([q[..., :d.N], rope(q[..., d.N:], pos, d.theta)], dim=-1).transpose(1, 2)  # (B, H, S, N + P)
    k = torch.cat([kvb[..., :d.N], k_pe.expand(b, s, d.H, d.P)], dim=-1).transpose(1, 2)
    v = kvb[..., d.N:].transpose(1, 2)
    out = torch.empty((b, d.H, s, d.VH), device=x.device)
    for a in range(0, s, q_block):
        e = min(s, a + q_block)
        sc = (q[:, :, a:e] @ k[:, :, :e].transpose(-1, -2)) * (d.N + d.P) ** -0.5
        mask = torch.arange(e, device=x.device)[None, :] <= torch.arange(a, e, device=x.device)[:, None]
        sc = sc.masked_fill(~mask, float("-inf"))
        out[:, :, a:e] = torch.softmax(sc, dim=-1) @ v[:, :, :e]
    return mm(out.transpose(1, 2).reshape(b, s, d.H * d.VH), w["wo"].reshape(-1, d.D), quant)


def swiglu(x, gate, up, down, quant=None):
    return mm(F.silu(mm(x, gate, quant)) * mm(x, up, quant), down, quant)


def route(d: Dims, w: dict, t: torch.Tensor, quant=None):
    """Tokens t (T, D) -> (gates (T, K), experts (T, K)): sigmoid scores,
    the K largest of scores plus the correction bias (the lower index first
    among equals), gated by their scores renormalised and scaled."""
    scores = torch.sigmoid(mm(t, w["router"], quant))
    top = torch.sort(scores + w["bias"], dim=-1, descending=True, stable=True)[1][:, :d.K]
    g = scores.gather(-1, top)
    return g / (g.sum(-1, keepdim=True) + 1e-20) * d.scale, top


def moe(d: Dims, w: dict, x: torch.Tensor, quant=None) -> torch.Tensor:
    """The expert layer of x (B, S, D): each token through its K routed
    experts, weighed by their gates, none dropped; plus the shared experts."""
    b, s, _ = x.shape
    t = x.reshape(-1, d.D)
    gates, top = route(d, w, t, quant)
    per = torch.zeros((t.shape[0], d.K, d.D), device=x.device)
    for e in range(d.E):
        rows, slot = (top == e).nonzero(as_tuple=True)
        if rows.numel():
            per[rows, slot] = swiglu(t[rows], w["gate"][e], w["up"][e], w["down"][e], quant)
    y = (per * gates[..., None]).sum(1)
    sh = w["shared"]
    return (y + swiglu(t, sh["gate"], sh["up"], sh["down"], quant)).view(b, s, d.D)


def block(d: Dims, w: dict, h: torch.Tensor, quant=None) -> torch.Tensor:
    """One decoder layer over h (B, S, D)."""
    h = h + attention(d, w["attn"], rms(h, w["norm"], d.eps), quant)
    hn = rms(h, w["ffn_norm"], d.eps)
    if "moe" in w:
        return h + moe(d, w["moe"], hn, quant)
    f = w["ffn"]
    return h + swiglu(hn, f["gate"], f["up"], f["down"], quant)


def _as32(tree):
    if isinstance(tree, dict):
        return {k: _as32(v) for k, v in tree.items()}
    return tree.float()


def head(d: Dims, params: dict, h: torch.Tensor, quant=None) -> torch.Tensor:
    w = params["embed"].float().T if d.tied else params["lm_head"].float()
    return mm(rms(h, params["final_norm"].float(), d.eps), w, quant)


# ---------------------------------------------------------------------------
# Serving: the logits at each served token's position
# ---------------------------------------------------------------------------


@torch.no_grad()
def served_logits(cfg: dict, params: dict, seqs: list[torch.Tensor], prompts: list[int], quant=None) -> list:
    """For each sequence (its prompt and then its served tokens but the
    last, 1-D int64) the float32 logits (n_served, V) at the positions that
    predict its served tokens: ``prompt - 1 ..``. One layer at a time over
    every sequence, its weights widened to float32 while it runs."""
    fp32()
    d = dims(cfg)
    hs = [params["embed"][s].float()[None] for s in seqs]
    for layer in params["layers"]:
        w = _as32(layer)
        hs = [block(d, w, h, quant) for h in hs]
        del w
    return [head(d, params, h[0, p - 1:], quant) for h, p in zip(hs, prompts)]
