"""Multi-head latent attention (``models/attention.py``'s MLA path,
``kernels/ops.py::latent_decode_attention``) and its latent arena, on the
CPU in float32 at a small cut of ``moonlight-16b-a3b``:

* the absorbed decode step equals the full, not absorbed, attention over
  the same positions, and prefill then decode equals the forward pass;
* the latent cache holds ``kv_lora_rank + qk_rope_head_dim`` values a
  token and layer, 576 at the published widths;
* an inactive row of the arena keeps its latent, its RoPE key and its
  position, bit for bit, and its token and cache change no active row
  beyond round-off;
* ``latent_decode_attention`` returns 0 for a row with no valid key, and
  its masked probabilities are exact zeros.

The ``gpu``-marked tests run a three-layer cut at the published widths on
the card: the arena's decode step replays as one CUDA graph with the eager
step's streams, and neither the prefill nor the decode step waits for the
device (``torch.cuda.set_sync_debug_mode("error")``).
"""

import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.kernels import ops
from repro_torch.launch.serve import Request, ServeLoop
from repro_torch.models import attention as attn
from repro_torch.models import model as M

TINY = dict(num_layers=3, d_model=32, num_heads=4, num_kv_heads=4, head_dim=12, d_ff=48, moe_d_ff=16,
            shared_d_ff=32, vocab_size=64, num_experts=8, experts_per_token=2, kv_lora_rank=16,
            qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8, compute_dtype="float32")
TOL = 2e-5  # fp32: the absorbed step sums q·W_k·c in another order than q·(c·W_k)
RUN = RunConfig(attention_impl="pallas", decode_attention_impl="kernel", remat="none")


def _cfg(**over):
    return dataclasses.replace(get_config("moonlight-16b-a3b"), **{**TINY, **over})


def _params(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    params = M.init_model(cfg, g)
    for blk in params["layers"]:
        if "moe" in blk:
            blk["moe"]["bias"].normal_(0.0, 0.05, generator=g)
        blk["attn"]["kv_norm"].normal_(0.0, 0.1, generator=g)
    return params


def test_absorbed_decode_equals_the_full_attention_over_the_same_cache():
    cfg = _cfg()
    w = _params(cfg)["layers"][0]["attn"]
    x = torch.randn(2, 11, cfg.d_model, generator=torch.Generator().manual_seed(1))
    full = attn.mla_apply_full(cfg, RUN, w, x, torch.arange(11)[None])
    layout = attn.attn_cache_layout(cfg, 2, 16)
    cache = {k: torch.zeros(shape, dtype=dt) for k, (shape, dt, _) in layout.items()}
    _, new = attn.mla_apply_full(cfg, RUN, w, x[:, :10], torch.arange(10)[None], return_kv=True)
    attn.attn_fill_cache(cfg, cache, new)
    step = attn.mla_apply_step(cfg, w, cache, x[:, 10:], torch.tensor([10, 10]))
    assert float((step[:, 0] - full[:, 10]).abs().max()) < TOL * float(full.abs().max())


def test_prefill_then_decode_equals_forward():
    cfg = _cfg()
    params = _params(cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 20), generator=torch.Generator().manual_seed(2))
    full, _ = M.forward(cfg, RUN, params, toks)
    logits, cache = M.prefill(cfg, RUN, params, toks[:, :13], max_len=24)
    assert set(cache) == {"pos", "c_kv", "k_pe"}
    assert float((logits[:, 0] - full[:, 12]).abs().max()) < TOL * float(full.abs().max())
    for t in range(13, 20):
        logits, cache = M.decode_step(cfg, RUN, params, cache, toks[:, t:t + 1])
        assert float((logits[:, 0] - full[:, t]).abs().max()) < TOL * float(full.abs().max()), t


@pytest.mark.parametrize("published", [True, False])
def test_the_latent_cache_holds_latent_and_rope_values_a_token(published):
    cfg = get_config("moonlight-16b-a3b") if published else _cfg()
    layout = M._cache_layout(cfg, 3, 40)
    assert set(layout) == {"pos", "c_kv", "k_pe"}
    per_token = sum(shape[-1] for key, (shape, _, _) in layout.items() if key != "pos")
    assert per_token == cfg.kv_lora_rank + cfg.qk_rope_head_dim
    assert all(shape[:3] == (cfg.num_layers, 3, 40) for key, (shape, _, _) in layout.items() if key != "pos")
    if published:
        assert per_token == 576
        # 31,104 bytes a token in bf16 over the 27 layers
        assert cfg.num_layers * per_token * 2 == 31_104


def test_an_inactive_row_of_the_arena_is_left_unchanged():
    cfg = _cfg()
    params = _params(cfg)
    g = torch.Generator().manual_seed(3)
    _, base = M.prefill(cfg, RUN, params, torch.randint(0, cfg.vocab_size, (3, 9), generator=g), max_len=16)
    act = torch.tensor([True, False, True])
    outs = []
    for variant in range(3):
        cache = {k: v.clone() for k, v in base.items()}
        tok = torch.tensor([[5], [variant * 17 + 1], [7]])
        if variant:  # the parked row's latent and RoPE key changed: no active row may notice
            cache["c_kv"][:, 1].normal_(generator=torch.Generator().manual_seed(variant))
            cache["k_pe"][:, 1].normal_(generator=torch.Generator().manual_seed(variant + 9))
        before = {k: v[:, 1].clone() if k != "pos" else v[1].clone() for k, v in cache.items()}
        logits, cache = M.decode_step(cfg, RUN, params, cache, tok, active=act)
        assert all(torch.equal(cache[k][:, 1] if k != "pos" else cache[k][1], v) for k, v in before.items())
        outs.append(logits[act])
    assert cache["pos"].tolist() == [10, 9, 10]
    # the active rows' logits agree to fp32 round-off, not bit for bit: the parked row's token moves
    # which experts' row blocks the grouped products see, and the CPU's GEMM blocks by the rows it gets
    assert all(float((o - outs[0]).abs().max()) < TOL * float(outs[0].abs().max()) for o in outs[1:])


def test_latent_decode_attention_on_an_all_invalid_row_returns_zero():
    g = torch.Generator().manual_seed(4)
    b, h, r, p, s = 3, 4, 16, 4, 10
    q_lat, q_pe = torch.randn(b, h, r, generator=g), torch.randn(b, h, p, generator=g)
    c_kv, k_pe = torch.randn(b, s, r, generator=g), torch.randn(b, s, p, generator=g)
    valid = torch.zeros(b, s, dtype=torch.bool)
    valid[0, :4] = True
    valid[2] = True
    out = ops.latent_decode_attention(q_lat, q_pe, c_kv, k_pe, valid, softmax_scale=0.3)
    assert torch.equal(out[1], torch.zeros(h, r))
    # the valid rows: a masked softmax over their keys alone
    for i in (0, 2):
        keys = valid[i].nonzero()[:, 0]
        sc = (q_lat[i] @ c_kv[i, keys].T + q_pe[i] @ k_pe[i, keys].T) * 0.3
        assert torch.allclose(out[i], torch.softmax(sc, -1) @ c_kv[i, keys], atol=1e-6)
    # a key past the valid ones changes nothing: its probability is an exact zero
    c2 = c_kv.clone()
    c2[0, 4:] = 1e6
    assert torch.equal(ops.latent_decode_attention(q_lat, q_pe, c2, k_pe, valid, softmax_scale=0.3)[0], out[0])


# ---------------------------------------------------------------------------
# On the card: the published widths, three layers
# ---------------------------------------------------------------------------


def _card_cut():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA kernels have no CPU mode")
    cfg = dataclasses.replace(get_config("moonlight-16b-a3b"), num_layers=3, vocab_size=32_768)
    g = torch.Generator(device="cuda").manual_seed(0)
    params = M.init_model(cfg, g, dtype=torch.bfloat16)
    for blk in params["layers"][1:]:
        blk["moe"]["bias"].normal_(0.0, 0.05, generator=g)
    return cfg, params


@pytest.mark.gpu
def test_moonlight_arena_decode_replays_as_one_graph_on_card():
    """Three layers of Moonlight at its widths, bf16, K2 prefill: a warmed
    arena replays every decode step as one CUDA graph and serves the same
    streams as an eager arena (``warmup=False``)."""
    cfg, params = _card_cut()
    g = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g).numpy() for n in (700, 1500, 333, 1024, 90)]

    def serve(warmup):
        loop = ServeLoop(cfg, RUN, params, batch=4, max_len=1600, mode="arena", warmup=warmup, device="cuda")
        reqs = [Request(i, p, 12 + i) for i, p in enumerate(prompts)]
        loop.start(reqs, prompt_len=64)
        while loop.tick() != "done":
            pass
        return [r.tokens for r in reqs], loop.stats()

    replayed, stats = serve(True)
    eager, stats_eager = serve(False)
    assert stats["decode_graph_replays"] == stats["decode_calls"] > 0
    assert stats_eager["decode_graph_replays"] == 0
    assert replayed == eager
    assert stats["moe_pairs"] == sum(len(p) for p in prompts) * cfg.experts_per_token * (cfg.num_layers - 1)


@pytest.mark.gpu
def test_moonlight_prefill_and_decode_do_not_sync_on_card():
    """The prefill (K2, the dropless dispatch over thousands of pairs, the
    load counter) and the decode step (absorbed attention, dispatch) issue
    no call that waits for the device."""
    cfg, params = _card_cut()
    toks = torch.randint(0, cfg.vocab_size, (1, 3000), device="cuda")
    load = torch.zeros(2, dtype=torch.long, device="cuda")
    act = torch.tensor([True, False, True, False], device="cuda")
    for _ in range(2):  # the first call builds and loads K2
        torch.cuda.set_sync_debug_mode("error")
        try:
            logits, cache = M.prefill(cfg, RUN, params, toks, 3100, moe_load=load)
            arena = M.init_cache(cfg, 4, 3100, "cuda")
            for name in ("c_kv", "k_pe"):
                arena[name][:, :1] = cache[name]
            arena["pos"][:1] = cache["pos"]
            step, _ = M.decode_step(cfg, RUN, params, arena, logits.argmax(-1).expand(4, 1), active=act)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.isfinite(step).all()
    assert load.tolist()[0] == 2 * 3000 * cfg.experts_per_token * (cfg.num_layers - 1)
