"""Plain PyTorch reference of the decoder stack that the configuration
``qwen3-1.7b.json`` describes, and the weights both the program and this
reference read.

It follows the configuration files and the published descriptions they
name, with each departure stated in the file's ``assumed``: pre-norm
blocks, RMSNorm with a zero-centred scale (``x * (1 + g)``), grouped-query
attention with rotary embeddings (rotate-half, ``rope_theta``) and, where
``qk_norm``, an RMSNorm of each q and k head; a SwiGLU FFN.

Everything is computed in float32 with TF32 off (``fp32()``), in blocks of
query rows and one layer at a time, so that it fits beside nothing: the
caller frees the program's state first. ``quant="fp8"`` is the control:
every weight product takes its inputs rounded to float8 e4m3, each row of
activations and each output column of a weight scaled to the format's
range, as an fp8 serving or training path would (in training the gradient
passes the rounding in float32).

As every reference of a configuration does, it states the contract between
its file and the program: ``program_sizes`` (the program's ``ModelConfig``
attributes that the file implies) and ``leaf_paths`` (every weight with its
shape), which ``benchlib/program.py::breaches`` holds the program to, and
``tiny_cut`` (its own cut to a size the CPU tests run in seconds).

It imports nothing of the program and no JAX.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0  # largest float8 e4m3 value


@dataclass(frozen=True)
class Dims:
    D: int
    H: int
    KH: int
    hd: int
    L: int
    V: int
    F: int  # FFN width
    eps: float
    theta: float
    tied: bool
    qk_norm: bool


def dims(cfg: dict) -> Dims:
    """The sizes of a configuration file, under the keys of its source."""
    a = cfg.get("assumed", {})
    h = cfg["num_attention_heads"]
    return Dims(
        D=cfg["hidden_size"], H=h, KH=cfg["num_key_value_heads"],
        hd=cfg.get("head_dim") or cfg["hidden_size"] // h, L=cfg["num_hidden_layers"], V=cfg["vocab_size"],
        F=cfg["intermediate_size"],
        eps=cfg["rms_norm_eps"], theta=float(cfg["rope_theta"]), tied=bool(cfg["tie_word_embeddings"]),
        qk_norm=bool(a.get("qk_norm", False)),
    )


def program_sizes(cfg: dict) -> dict:
    """The attributes of the program's ``ModelConfig`` that a configuration
    file implies, each with its value: what the program built from the file
    has to hold. No layer routes over experts."""
    d = dims(cfg)
    return {"num_layers": d.L, "d_model": d.D, "num_heads": d.H, "num_kv_heads": d.KH, "head_dim_": d.hd,
            "vocab_size": d.V, "tie_embeddings": d.tied, "norm_eps": d.eps, "rope_theta": d.theta,
            "qk_norm": d.qk_norm, "d_ff": d.F, "num_experts": 0}


def tiny_cut() -> tuple[dict, dict]:
    """A cut of this architecture that the CPU runs in seconds: the file's
    keys and the program's overrides that make it two layers 64 wide with a
    vocabulary of 256."""
    return ({"num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
             "head_dim": 16, "intermediate_size": 128, "vocab_size": 256},
            {"num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 2, "head_dim": 16, "d_ff": 128,
             "vocab_size": 256})


def fp32() -> None:
    """Float32 products in float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# Weights: made from the seed on the device, in a few large calls
# ---------------------------------------------------------------------------


def _layer_leaves(d: Dims) -> list[tuple[tuple[str, ...], tuple[int, ...], str]]:
    """(path inside the layer, shape, kind) of one layer's weights. A
    kind's leaves share an initial scale."""
    out = [(("norm",), (d.D,), "norm"),
           (("attn", "wq"), (d.D, d.H, d.hd), "in"), (("attn", "wk"), (d.D, d.KH, d.hd), "in"),
           (("attn", "wv"), (d.D, d.KH, d.hd), "in"), (("attn", "wo"), (d.H, d.hd, d.D), "attn_out")]
    if d.qk_norm:
        out += [(("attn", "q_norm"), (d.hd,), "norm"), (("attn", "k_norm"), (d.hd,), "norm")]
    out += [(("ffn_norm",), (d.D,), "norm"), (("ffn", "gate"), (d.D, d.F), "in"), (("ffn", "up"), (d.D, d.F), "in"),
            (("ffn", "down"), (d.F, d.D), "ffn_out")]
    return out


def _scale(d: Dims, kind: str) -> float:
    """Initial standard deviation of a kind: 1/sqrt(fan-in), 0.02 for the
    embedding; norms start at zero (a scale of 1)."""
    return {"in": d.D ** -0.5, "attn_out": (d.H * d.hd) ** -0.5, "ffn_out": d.F ** -0.5, "embed": 0.02,
            "head": d.D ** -0.5, "norm": 0.0}[kind]


def leaf_paths(d: Dims) -> list[tuple[tuple, tuple[int, ...], str]]:
    """Every weight: (path in the tree, shape, kind), in the tree's order."""
    out = [(("embed",), (d.V, d.D), "embed")]
    for i in range(d.L):
        out += [(("layers", i) + p, s, kind) for p, s, kind in _layer_leaves(d)]
    out.append((("final_norm",), (d.D,), "norm"))
    if not d.tied:
        out.append((("lm_head",), (d.D, d.V), "head"))
    return out


def _put(tree: dict, path: tuple, value) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(key, int):
            while len(node) <= key:
                node.append({})
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    node[path[-1]] = value


CHUNK = 1 << 28  # elements a call of the generator fills


def make_params(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The weights of ``cfg`` from ``seed``, on ``device`` in ``dtype``:
    one buffer, the leaves of each kind side by side in it, filled with
    normal numbers by a ``torch.Generator`` on the device in calls of
    :data:`CHUNK` elements and scaled a kind at a time. The tree is the
    program's: ``{"embed", "layers": [...], "final_norm", "lm_head"}``, each
    leaf a view of the buffer. The same seed, device and dtype give the
    same weights."""
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


def _round(x: torch.Tensor, quant: str, dim: int) -> torch.Tensor:
    """x rounded to ``quant``, float8 e4m3, scaled along ``dim`` to the
    format's range. The gradient passes the rounding unchanged (in float32),
    as a low-precision forward with a float32 backward."""
    with torch.no_grad():
        if quant != "fp8":
            raise ValueError(f"unknown rounding {quant!r}")
        s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
        r = (x / s).to(torch.float8_e4m3fn).float() * s
    return x + (r - x).detach() if x.requires_grad else r


def mm(x: torch.Tensor, w: torch.Tensor, quant=None) -> torch.Tensor:
    """x (..., K) @ w (K, N) in float32; with ``quant`` ("fp8": the control)
    both operands rounded first (x by rows, w by output columns)."""
    if quant:
        return _round(x, quant, -1) @ _round(w, quant, 0)
    return x @ w


def rms(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + g)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (..., S, heads, hd) at positions ``pos`` (S,),
    the two halves of each head rotated together."""
    hd = x.shape[-1]
    inv = theta ** -(torch.arange(0, hd, 2, device=x.device, dtype=torch.float32) / hd)
    ang = (pos.float()[:, None] * inv)[:, None, :]
    c, s = ang.cos(), ang.sin()
    a, b = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([a * c - b * s, b * c + a * s], dim=-1)


def attention(d: Dims, w: dict, x: torch.Tensor, quant=None, q_block: int = 1024) -> torch.Tensor:
    """Causal self-attention of x (B, S, D) -> (B, S, D), softmax over the
    keys in float32, ``q_block`` query rows at a time."""
    b, s, _ = x.shape
    q = mm(x, w["wq"].reshape(d.D, -1), quant).view(b, s, d.H, d.hd)
    k = mm(x, w["wk"].reshape(d.D, -1), quant).view(b, s, d.KH, d.hd)
    v = mm(x, w["wv"].reshape(d.D, -1), quant).view(b, s, d.KH, d.hd)
    if d.qk_norm:
        q, k = rms(q, w["q_norm"], d.eps), rms(k, w["k_norm"], d.eps)
    pos = torch.arange(s, device=x.device)
    q, k = rope(q, pos, d.theta), rope(k, pos, d.theta)
    g = d.H // d.KH
    k = k.repeat_interleave(g, dim=2).transpose(1, 2)  # (B, H, S, hd)
    v = v.repeat_interleave(g, dim=2).transpose(1, 2)
    q = q.transpose(1, 2)
    out = torch.empty_like(q)
    for a in range(0, s, q_block):
        e = min(s, a + q_block)
        sc = (q[:, :, a:e] @ k[:, :, :e].transpose(-1, -2)) * d.hd ** -0.5
        mask = torch.arange(e, device=x.device)[None, :] <= torch.arange(a, e, device=x.device)[:, None]
        sc = sc.masked_fill(~mask, float("-inf"))
        out[:, :, a:e] = torch.softmax(sc, dim=-1) @ v[:, :, :e]
    return mm(out.transpose(1, 2).reshape(b, s, d.H * d.hd), w["wo"].reshape(-1, d.D), quant)


def swiglu(x, gate, up, down, quant=None):
    return mm(F.silu(mm(x, gate, quant)) * mm(x, up, quant), down, quant)


def block(d: Dims, w: dict, h: torch.Tensor, quant=None) -> torch.Tensor:
    """One decoder layer over h (B, S, D)."""
    h = h + attention(d, w["attn"], rms(h, w["norm"], d.eps), quant)
    f = w["ffn"]
    return h + swiglu(rms(h, w["ffn_norm"], d.eps), f["gate"], f["up"], f["down"], quant)


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
    every sequence, its weights widened to float32 once."""
    fp32()
    d = dims(cfg)
    hs = [params["embed"][s].float()[None] for s in seqs]
    for layer in params["layers"]:
        w = _as32(layer)
        hs = [block(d, w, h, quant) for h in hs]
        del w
    return [head(d, params, h[0, p - 1:], quant) for h, p in zip(hs, prompts)]


# ---------------------------------------------------------------------------
# Training: the steps of the program's trainer, in float32
# ---------------------------------------------------------------------------


def loss(cfg: dict, params: dict, tokens: torch.Tensor, z_loss: float, quant=None) -> torch.Tensor:
    """Next-token cross entropy over tokens (B, S), each position predicting
    the next, plus ``z_loss`` times the mean squared log-normaliser. Every
    layer is recomputed in the backward (activation checkpointing)."""
    d = dims(cfg)
    h = params["embed"][tokens]
    for w in params["layers"]:
        h = checkpoint(lambda h_, w_: block(d, w_, h_, quant), h, w, use_reentrant=False)
    logits = head(d, params, h[:, :-1], quant)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, tokens[:, 1:, None])[..., 0]
    return (lse - gold).mean() + z_loss * lse.square().mean()


def lr_at(opt: dict, step: int) -> float:
    """Linear warm-up to ``lr`` over ``warmup`` steps, then cosine decay to
    a tenth of it at ``total``."""
    warm = min(step / max(opt["warmup"], 1), 1.0)
    frac = min(max((step - opt["warmup"]) / max(opt["total"] - opt["warmup"], 1), 0.0), 1.0)
    return opt["lr"] * warm * (0.1 + 0.45 * (1.0 + math.cos(math.pi * frac)))


def train(cfg: dict, params: dict, batches, opt: dict, steps: int, microbatches: int, quant=None) -> dict:
    """``steps`` steps of AdamW from ``params`` (float32, left as they are),
    each on the mean gradient of ``microbatches`` microbatches taken from
    ``batches(i)`` (token tensors (B, S)), clipped to a global norm of
    ``opt["clip"]``. Returns every microbatch's loss, each leaf's norm of the
    first step's clipped gradient, and of its change over the ``steps``."""
    fp32()
    d = dims(cfg)
    names, start = zip(*leaves_of(params, d))
    ps = [p.detach().clone().requires_grad_(True) for p in start]
    params = {}
    for (path, _, _), p in zip(leaf_paths(d), ps):
        _put(params, path, p)
    mu = [torch.zeros_like(p) for p in ps]
    nu = [torch.zeros_like(p) for p in ps]
    losses, first = [], None
    b1, b2 = opt["beta1"], opt["beta2"]
    for step in range(1, steps + 1):
        for j in range(microbatches):
            lo = loss(cfg, params, batches((step - 1) * microbatches + j), opt["z_loss"], quant)
            (lo / microbatches).backward()
            losses.append(float(lo.detach()))
        with torch.no_grad():
            grads = [p.grad for p in ps]
            norm = torch.sqrt(sum(g.square().sum() for g in grads))
            scale = min(1.0, opt["clip"] / max(float(norm), 1e-9))
            if first is None:
                first = [float(g.norm()) * scale for g in grads]
            lr = lr_at(opt, step)
            for p, g, m, v in zip(ps, grads, mu, nu):
                g = g * scale
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                delta = (m / (1 - b1 ** step)) / (torch.sqrt(v / (1 - b2 ** step)) + opt["eps"]) \
                    + opt["weight_decay"] * p
                p.sub_(lr * delta)
                p.grad = None
    change = [float((p.detach() - s).norm()) for p, s in zip(ps, start)]
    return {"names": list(names), "losses": losses, "grad_norms": first, "change_norms": change}
