"""The plain reference agrees with the program, ``repro_torch``, at a tiny
size on the CPU in float32: the logits of a prefill and of each decode step
through the cache, for every configuration of ``BENCHMARK.json`` at its
reference's own cut, and the training steps of the program's trainer. And
the contract that each reference states for its configuration file
(``program_sizes``, ``leaf_paths``), as ``program.breaches`` holds the
program to it, passes where the program has those sizes and fails where
one differs: for a stub reference of a routed-expert model, defined here,
as for the dense reference."""

from __future__ import annotations

import copy
from types import SimpleNamespace

import pytest
import torch

from benchlib import program, spec

BENCH = spec.benchmark()
CONFIGS = [c["name"] for c in BENCH["configs"]]


def _cell_of(config: str):
    return spec.resolve(next(w["name"] for w in BENCH["workloads"] if w["config"] == config))


def _logits_of_program(mcfg, params, prompt, served):
    """The program's logits at each served token's position: its prefill's
    last position, then a decode step per served token but the last."""
    from repro_torch.models import model as M

    run = program.serve_run()  # K2 and K1: their plain versions on the CPU
    logits, cache = M.prefill(mcfg, run, params, prompt[None], prompt.shape[0] + len(served))
    out = [logits[0, -1]]
    for tok in served[:-1]:
        lg, cache = M.decode_step(mcfg, run, params, cache, torch.tensor([[tok]]))
        out.append(lg[0, -1])
    return torch.stack(out).float()


@pytest.mark.parametrize("n_prompt,n_served", [(48, 7), (17, 12)])
def test_served_logits_agree_with_the_program(tiny_cfg, n_prompt, n_served):
    for name in CONFIGS:
        c = _cell_of(name)
        cfg = tiny_cfg(c.cfg, c.ref)
        vocab = c.ref.dims(cfg).V
        mcfg = program.model_config(cfg)
        params = c.ref.make_params(cfg, 2**35 + 1, "cpu", torch.float32)
        gen = torch.Generator().manual_seed(4)
        prompt = torch.randint(0, vocab, (n_prompt,), generator=gen)
        served = torch.randint(0, vocab, (n_served,), generator=gen).tolist()
        mine = _logits_of_program(mcfg, params, prompt, served)
        seq = torch.cat([prompt, torch.tensor(served[:-1])])
        ref = c.ref.served_logits(cfg, params, [seq], [n_prompt])[0]
        assert ref.shape == mine.shape == (n_served, vocab), name
        assert float((ref - mine).abs().max()) < 1e-4 * float(ref.abs().max()), name


def test_training_steps_agree_with_the_program(tiny_cell):
    """The harness's training cell at a tiny size in float32: the judged
    gaps of the program's first steps against the reference are round-off."""
    from benchlib import train

    c = tiny_cell("qwen3-1.7b.train")
    data = train.run(c, c.ref, {})
    got = data["finish"]()
    assert got["loss"] < 1e-5 and got["grad"] < 1e-4 and got["change"] < 1e-4, got


def test_the_dense_reference_cuts_to_the_size_the_tests_always_used():
    from benchlib import host

    ref = spec.load_module(host.BENCH_DIR / "configs" / "transformer_ref.py")
    assert ref.tiny_cut() == (
        {"num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
         "head_dim": 16, "intermediate_size": 128, "vocab_size": 256},
        {"num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 2, "head_dim": 16, "d_ff": 128,
         "vocab_size": 256})


def test_the_dense_contract_rejects_a_program_that_routes_over_experts():
    c = _cell_of(CONFIGS[0])
    cfg = copy.deepcopy(c.cfg)
    cfg["program"] = dict(cfg["program"], overrides=dict(cfg["program"].get("overrides", {}), num_experts=8,
                                                         experts_per_token=2))
    got = program.breaches(c.ref, cfg)
    assert any(b.startswith("num_experts:") for b in got), got
    assert any("ffn" in b for b in got), got  # its expert layers hold no dense FFN


class MoeStub:
    """A stub reference of a routed-expert decoder with full multi-head
    attention, stating the contract for a configuration file under the keys
    of a DeepSeek-style ``config.json``: what the program has to hold, and
    every weight with its shape, each layer's FFN routed over
    ``n_routed_experts`` experts of width ``moe_intermediate_size``."""

    @staticmethod
    def dims(cfg):
        return SimpleNamespace(L=cfg["num_hidden_layers"], D=cfg["hidden_size"], H=cfg["num_attention_heads"],
                               KH=cfg["num_key_value_heads"], hd=cfg["head_dim"], E=cfg["n_routed_experts"],
                               F=cfg["moe_intermediate_size"], V=cfg["vocab_size"])

    @staticmethod
    def program_sizes(cfg):
        d = MoeStub.dims(cfg)
        return {"num_layers": d.L, "d_model": d.D, "num_heads": d.H, "num_kv_heads": d.KH, "head_dim_": d.hd,
                "vocab_size": d.V, "num_experts": d.E, "experts_per_token": cfg["num_experts_per_tok"],
                "ffn_dim": d.F, "rope_theta": float(cfg["rope_theta"]),
                "tie_embeddings": cfg["tie_word_embeddings"], "qk_norm": False}

    @staticmethod
    def tiny_cut():
        return ({"num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 4,
                 "head_dim": 16, "moe_intermediate_size": 32, "n_routed_experts": 4, "num_experts_per_tok": 2,
                 "vocab_size": 256},
                {"num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 4, "head_dim": 16, "d_ff": 32,
                 "moe_d_ff": 32, "num_experts": 4, "experts_per_token": 2, "vocab_size": 256})

    @staticmethod
    def leaf_paths(d):
        layer = [(("norm",), (d.D,)), (("attn", "wq"), (d.D, d.H, d.hd)), (("attn", "wk"), (d.D, d.KH, d.hd)),
                 (("attn", "wv"), (d.D, d.KH, d.hd)), (("attn", "wo"), (d.H, d.hd, d.D)), (("ffn_norm",), (d.D,)),
                 (("moe", "router"), (d.D, d.E)), (("moe", "gate"), (d.E, d.D, d.F)),
                 (("moe", "up"), (d.E, d.D, d.F)), (("moe", "down"), (d.E, d.F, d.D))]
        out = [(("embed",), (d.V, d.D), "embed")]
        out += [(("layers", i) + p, s, "w") for i in range(d.L) for p, s in layer]
        return out + [(("final_norm",), (d.D,), "norm"), (("lm_head",), (d.D, d.V), "head")]


# the sizes of the program's moonshot-v1-16b-a3b preset, as such a file would state them
MOE_FILE = {"program": {"preset": "moonshot-v1-16b-a3b"}, "num_hidden_layers": 48, "hidden_size": 2048,
            "num_attention_heads": 16, "num_key_value_heads": 16, "head_dim": 128, "moe_intermediate_size": 1408,
            "n_routed_experts": 64, "num_experts_per_tok": 6, "vocab_size": 163840, "rope_theta": 50000,
            "tie_word_embeddings": False}


@pytest.mark.parametrize("cut", [False, True])
def test_a_moe_reference_that_states_the_programs_sizes_passes_the_contract(tiny_cfg, cut):
    cfg = tiny_cfg(MOE_FILE, MoeStub) if cut else MOE_FILE
    assert program.breaches(MoeStub, cfg) == []


@pytest.mark.parametrize("key,value", [("n_routed_experts", 32), ("moe_intermediate_size", 1536),
                                       ("num_hidden_layers", 27), ("num_experts_per_tok", 8),
                                       ("tie_word_embeddings", True)])
def test_a_moe_reference_with_one_size_changed_fails_the_contract(key, value):
    got = program.breaches(MoeStub, dict(MOE_FILE, **{key: value}))
    assert got, (key, value)
