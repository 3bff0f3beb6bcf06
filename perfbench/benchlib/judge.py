"""The comparisons that decide ``correct``, against the plain reference of
the configuration (``configs/<reference>.py``).

Serving: a sample of the requests, drawn from the seed with the longest
in it, until it holds ``check.served_tokens`` served tokens; the reference
runs once over each prompt with its served tokens. The gap of a served
token is how far its logit lies below the reference's best at its position
(greedy tokens only); the numbers are the widest gap, ``gap``, which every
served mix limits, and the mean gap over the sample, ``mean_gap``, which a
mix may limit beside it.

Training: the first steps of the run, followed by the reference from the
same weights on the same microbatches: each microbatch's loss, each leaf's
norm of the first step's gradient as the optimizer got it, and each leaf's
norm of its change over the steps, each as a gap against the reference's
(relative to the reference's norm of that leaf or of the median leaf,
whichever is larger; the loss relative to the reference's loss).
"""

from __future__ import annotations

import statistics

import numpy as np
import torch


def sample(reqs, seed: int, tokens: int):
    """Requests to check: the longest (prompt and served tokens), then
    others in an order drawn from the seed, until ``tokens`` served tokens
    are in. Only requests that served a token are drawn."""
    have = [r for r in reqs if len(r.tokens)]
    if not have:
        return []
    have.sort(key=lambda r: (-(len(r.prompt) + len(r.tokens)), r.rid))
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 7])
    rest = [have[i] for i in rng.permutation(np.arange(1, len(have)))]
    out, n = [], 0
    for r in [have[0]] + rest:
        out.append(r)
        n += len(r.tokens)
        if n >= tokens:
            break
    return out


def _seqs(reqs, device):
    seqs = [torch.as_tensor(np.concatenate([np.asarray(r.prompt), np.asarray(r.tokens[:-1], np.int64)]),
                            dtype=torch.long, device=device) for r in reqs]
    return seqs, [len(r.prompt) for r in reqs]


def serve_gaps(ref, cfg: dict, params: dict, reqs, device, control: bool = False) -> dict:
    """The widest and the mean gap of the served tokens of ``reqs`` below
    the float32 reference's best logit; with ``control``, also those of the
    tokens that the fp8 control would put first at the same positions."""
    seqs, prompts = _seqs(reqs, device)
    logits = ref.served_logits(cfg, params, seqs, prompts)
    served = [torch.as_tensor(r.tokens, device=device) for r in reqs]
    gaps = torch.cat([lg.max(-1).values - lg.gather(-1, s[:, None])[:, 0] for lg, s in zip(logits, served)])
    out = {"gap": float(gaps.max()), "mean_gap": float(gaps.mean()), "tokens": int(gaps.numel()),
           "disagree": int((gaps > 0).sum())}
    if control:
        low = ref.served_logits(cfg, params, seqs, prompts, quant="fp8")
        g = torch.cat([lg.max(-1).values - lg.gather(-1, c.argmax(-1)[:, None])[:, 0] for lg, c in zip(logits, low)])
        out["control_gap"], out["control_mean_gap"] = float(g.max()), float(g.mean())
    return out


def _rel(prog, refv, floor):
    return abs(prog - refv) / max(abs(refv), floor)


def train_gaps(prog: dict, refr: dict) -> dict:
    """Worst gaps of the program's training readings against the
    reference's. ``prog`` and ``refr`` hold ``losses`` (one per
    microbatch), ``grad_norms`` and ``change_norms`` (one per leaf, in the
    same order). A leaf whose reference gradient is under a thousandth of
    the median leaf's moves by round-off alone and is left out of the
    change."""
    n = len(refr["losses"])
    loss = max(_rel(a, b, 0.0) for a, b in zip(prog["losses"][:n], refr["losses"]))
    g_med = statistics.median(refr["grad_norms"])
    grad = max(_rel(a, b, g_med) for a, b in zip(prog["grad_norms"], refr["grad_norms"]))
    moved = [i for i, g in enumerate(refr["grad_norms"]) if g >= 1e-3 * g_med]
    c_med = statistics.median(refr["change_norms"][i] for i in moved)
    change = max(_rel(prog["change_norms"][i], refr["change_norms"][i], c_med) for i in moved)
    worst = max(moved, key=lambda i: _rel(prog["change_norms"][i], refr["change_norms"][i], c_med))
    worst_g = max(range(len(refr["grad_norms"])),
                  key=lambda i: _rel(prog["grad_norms"][i], refr["grad_norms"][i], g_med))
    return {"loss": loss, "grad": grad, "change": change, "left_out": len(refr["grad_norms"]) - len(moved),
            "worst_grad_leaf": refr["names"][worst_g], "worst_change_leaf": refr["names"][worst]}


def verdict(limits: dict, got: dict) -> tuple[bool, dict]:
    """``(correct, checks)``: each compared number beside its limit (the
    mix's ``check.limits``). A request still open when the drain ends is
    late, not wrong: it counts in the latencies, never here."""
    checks = {k: {"value": got[k], "limit": lim} for k, lim in limits.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
