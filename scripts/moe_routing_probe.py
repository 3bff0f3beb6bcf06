#!/usr/bin/env python3
"""How alike a random-weight MoE stack's tokens look to its router.

Prefills one SyntheticCorpus prompt of 512 tokens, one dispatch group (and
one of uniformly drawn token ids), through the port's moonshot-v1-16b-a3b
at its published widths, cut in depth, on random weights from a seeded
generator, on the card, and prints for each MoE
layer the share of (token, slot) pairs dropped at the eval capacity
factor and the mean cosine similarity between the tokens' MoE inputs.
Where the inputs grow alike, the tokens choose the same experts and the
capacity (twice the fair share) drops the rest.

  PYTHONPATH=src python3 scripts/moe_routing_probe.py [--layers 8]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.data.dataset import SyntheticCorpus  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402

SEQ = 512  # moonshot's moe_group_size: one dispatch group

def probe(cfg, params, tokens: np.ndarray, device) -> list[tuple[float, float]]:
    """(dropped share, mean cosine between tokens' MoE inputs) per layer."""
    seen = []
    real = moe.moe_apply

    def spy(c, p, x, inference=False, **kw):
        y, aux = real(c, p, x, inference=inference, **kw)
        xs = x.reshape(-1, x.shape[-1]).float()
        xs = xs / xs.norm(dim=-1, keepdim=True)
        seen.append((float(aux["moe_drop_frac"]), float((xs @ xs.T).mean())))
        return y, aux

    run = RunConfig(attention_impl="pallas", decode_attention_impl="kernel")
    with mock.patch.object(moe, "moe_apply", spy):
        M.prefill(cfg, run, params, torch.as_tensor(tokens, dtype=torch.long, device=device), tokens.shape[1] + 8)
    return seen


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=8, help="depth cut (48 published)")
    args = ap.parse_args(argv)
    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"), num_layers=args.layers)
    dev = torch.device(args.device)
    params = M.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dtype=getattr(torch, cfg.compute_dtype))
    prompts = {"corpus": SyntheticCorpus(cfg.vocab_size, SEQ, 0).grain_tokens(0, 1),
               "uniform": np.random.default_rng(0).integers(0, cfg.vocab_size, (1, SEQ))}
    out = {"config": {k: getattr(cfg, k) for k in ("num_layers", "d_model", "num_heads", "num_experts",
                                                    "experts_per_token", "ffn_dim", "moe_group_size",
                                                    "compute_dtype")},
           "device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"}
    for name, tokens in prompts.items():
        out[name] = probe(cfg, params, tokens, dev)
        print(f"{name} prompt of {SEQ} ({out['device']}): per layer (dropped share, mean cosine of MoE "
              "inputs): " + ", ".join(f"({d:.3f}, {c:.3f})" for d, c in out[name]))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
