"""The port's sharding rules and spec helpers against the JAX package's.

No ranks here: ``ShardingRules`` decides from mesh axis names and sizes
alone. Twins of the five rule tests of ``tests/test_sharding.py``, held
against ``repro.parallel.sharding.ShardingRules`` itself; for every arch at
its published widths, on the ``("data", "model") (16, 16)`` and ``("pod",
"data", "model") (2, 16, 16)`` meshes, ``model_specs``, ``cache_specs`` and
``opt_state_specs`` equal the JAX package's leaf for leaf (the port's
``layers[i]`` is the reference's ``layers/b{i % period}`` without its
leading stack dim; the port's cache stacks each kind of state over its
layers, so its spec is the reference's per-layer spec of that kind); the
twins of ``test_model_specs_align_with_defs`` (every arch) and
``test_llama405b_fits_hbm_when_fully_sharded`` (against the H100's HBM);
``resolve_moe_axes``; the placements a spec becomes on DTensor.
"""

import itertools
from types import SimpleNamespace

import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.hadoop_cluster import H100_HBM_GB
from repro_torch.configs.base import RunConfig
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import attention as attn
from repro_torch.models import model as M
from repro_torch.models.moe import resolve_moe_axes
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import P, ShardingRules, logical_spec, spec_placements

try:
    import jax
    from jax.sharding import PartitionSpec as JP

    from repro.configs import get_config as jax_get_config
    from repro.models import model as JM
    from repro.models.moe import resolve_moe_axes as jax_resolve_moe_axes
    from repro.optim import adamw as jadamw
    from repro.parallel.sharding import ShardingRules as JaxRules
except ImportError:  # the card's machine has no JAX
    jax = None

SINGLE = ShardingRules(("data", "model"), (16, 16))
MULTI = ShardingRules(("pod", "data", "model"), (2, 16, 16))
MESHES = {"single": (("data", "model"), (16, 16)), "multi": (("pod", "data", "model"), (2, 16, 16))}


@pytest.fixture
def jax_rules():
    if jax is None:
        pytest.skip("JAX is not installed: the reference side of this test is missing")
    return {k: JaxRules(*v) for k, v in MESHES.items()}


def _same(port_spec, jax_spec):
    """A port spec equals a JAX spec entry for entry."""
    return tuple(port_spec) == tuple(jax_spec)


# --- twins of tests/test_sharding.py ------------------------------------------


RULE_CASES = [
    # test_basic_resolution
    ("single", {}, ("batch", None), (256, 4096)),
    ("multi", {}, ("batch", None), (256, 4096)),
    ("single", {}, ("fsdp", "tp"), (4096, 16384)),
    # test_divisibility_degrades_to_replication
    ("single", {}, ("batch", None), (1, 8)),
    ("single", {}, (None, "tp", None), (8, 24, 64)),
    ("single", {}, ("batch", None, "tp", None), (128, 1, 8, 128)),
    # test_no_axis_used_twice
    ("single", {}, ("expert", "fsdp", "moe_tp"), (64, 2048, 1408)),
    ("single", {}, ("expert", "fsdp", "moe_tp"), (8, 6144, 16384)),
    # test_fsdp_off
    ("single", {"fsdp": False}, ("fsdp", "tp"), (4096, 16384)),
    # test_sequence_parallel_toggle
    ("single", {}, ("batch", "sp", None), (256, 4096, 8192)),
    ("single", {"sequence_parallel": False}, ("batch", "sp", None), (256, 4096, 8192)),
    # no shape: nothing is dropped for divisibility
    ("multi", {}, ("fsdp", "kv_seq", "null", None), None),
]


def test_basic_resolution():
    assert SINGLE.spec(("batch", None), (256, 4096)) == P(("data",), None) == ("data", None)
    assert MULTI.spec(("batch", None), (256, 4096)) == P(("pod", "data"), None)
    assert SINGLE.spec(("fsdp", "tp"), (4096, 16384)) == P(("data",), "model")


def test_divisibility_degrades_to_replication():
    assert SINGLE.spec(("batch", None), (1, 8)) == P(None, None)
    assert SINGLE.spec((None, "tp", None), (8, 24, 64)) == P(None, None, None)
    assert SINGLE.spec(("batch", None, "tp", None), (128, 1, 8, 128)) == P(("data",), None, None, None)


def test_no_axis_used_twice():
    assert SINGLE.spec(("expert", "fsdp", "moe_tp"), (64, 2048, 1408)) == P("model", ("data",), None)
    assert SINGLE.spec(("expert", "fsdp", "moe_tp"), (8, 6144, 16384)) == P(None, ("data",), "model")


def test_fsdp_off():
    rules = ShardingRules(("data", "model"), (16, 16), fsdp=False)
    assert rules.spec(("fsdp", "tp"), (4096, 16384)) == P(None, "model")


def test_sequence_parallel_toggle():
    on = SINGLE.spec(("batch", "sp", None), (256, 4096, 8192))
    off = ShardingRules(("data", "model"), (16, 16), sequence_parallel=False).spec(
        ("batch", "sp", None), (256, 4096, 8192))
    assert on == P(("data",), "model", None)
    assert off == P(("data",), None, None)


@pytest.mark.parametrize("mesh,flags,axes,shape", RULE_CASES)
def test_rules_match_reference(mesh, flags, axes, shape, jax_rules):
    port = ShardingRules(*MESHES[mesh], **flags)
    ref = JaxRules(*MESHES[mesh], **flags)
    assert _same(port.spec(axes, shape), ref.spec(axes, shape))
    assert (port.dp_axes, port.dp_size, port.tp_size) == (ref.dp_axes, ref.dp_size, ref.tp_size)
    for name in ("pod", "data", "model", "expert"):
        assert port.axis_size(name) == ref.axis_size(name)


def test_rules_reject_unknown_axis_and_keep_mesh_out_of_equality():
    with pytest.raises(ValueError, match="unknown logical axis"):
        SINGLE.spec(("heads",))
    assert ShardingRules(("data", "model"), (16, 16), mesh=object()) == SINGLE
    assert logical_spec(None, ("batch",)) == P() == ()
    assert logical_spec(SINGLE, ("batch", "tp"), (32, 32)) == P("data", "model")


# --- the spec helpers, every arch at published widths ---------------------------


def _jax_leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP))[0]


def _key(path):
    return tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path)


def _port_layer_spec(port_specs, cfg, key):
    """The port's spec for the reference's leaf ``key``: layers/b{j}/...
    maps to every layer i with i % period == j (its stack dim dropped)."""
    if key[0] != "layers":
        node = port_specs
        for k in key:
            node = node[k]
        return [(node, 0)]
    j = int(key[1][1:])
    out = []
    for i in range(j, cfg.num_layers, cfg.period):
        node = port_specs["layers"][i]
        for k in key[2:]:
            node = node[k]
        out.append((node, 1))
    return out


@pytest.mark.parametrize("arch,mesh", list(itertools.product(ARCH_IDS, MESHES)))
def test_model_and_opt_specs_match_reference(arch, mesh, jax_rules):
    cfg = get_config(arch)
    rules = ShardingRules(*MESHES[mesh])
    port = M.model_specs(cfg, rules)
    ref = JM.model_specs(jax_get_config(arch), jax_rules[mesh])
    leaves = _jax_leaves(ref)
    seen = 0
    for path, spec in leaves:
        for node, drop in _port_layer_spec(port, cfg, _key(path)):
            assert tuple(node) == tuple(spec)[drop:], (_key(path), node, spec)
            seen += 1
    assert seen == len(_flat(port))
    port_opt = adamw.opt_state_specs(port)
    ref_opt = jadamw.opt_state_specs(ref)
    assert tuple(port_opt["step"]) == tuple(ref_opt["step"]) == ()
    assert port_opt["mu"] is port and port_opt["nu"] is port
    assert ref_opt["mu"] is ref and ref_opt["nu"] is ref
    # with no rules every spec is P()
    assert all(tuple(s) == () for s in _flat(M.model_specs(cfg, None)))


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in _flat(t)]
    return [tree]


@pytest.mark.parametrize("arch,mesh", list(itertools.product(ARCH_IDS, MESHES)))
def test_model_specs_cover_every_param(arch, mesh):
    """One spec per param leaf, in the same tree."""
    cfg = get_config(arch)
    defs, specs = M.model_defs(cfg), M.model_specs(cfg, ShardingRules(*MESHES[mesh]))
    assert len(_flat(specs)) == len(_flat(defs))
    assert all(len(s) == len(d.shape) for s, d in zip(_flat(specs), _flat(defs)))


CACHE_SHAPES = [(32, 256), (1, 512)]  # (batch, max_len): dp-divisible batch, and batch 1


@pytest.mark.parametrize("arch,mesh", list(itertools.product(ARCH_IDS, MESHES)))
def test_cache_specs_match_reference(arch, mesh, jax_rules):
    cfg = get_config(arch)
    rules = ShardingRules(*MESHES[mesh])
    jcfg = jax_get_config(arch)
    counts = M._kind_counts(cfg)
    for batch, max_len in CACHE_SHAPES:
        port = M.cache_specs(cfg, rules, batch, max_len)
        ref = JM.cache_specs(jcfg, jax_rules[mesh], batch, max_len)
        assert tuple(port["pos"]) == tuple(ref["pos"]) == ()
        compared = 0
        for j in range(cfg.period):
            kind = cfg.layer_kind(j)
            blk = ref["layers"][f"b{j}"][kind]
            if kind == "attn":
                pairs = [(port["k"], blk["k"]), (port["v"], blk["v"])]
            elif kind == "mamba":
                pairs = [(port["mamba"][k], blk[k]) for k in ("conv_x", "conv_b", "conv_c", "ssm")]
            elif kind == "mlstm":
                pairs = [(port["mlstm"], blk["state"])]
            else:
                pairs = [(port["slstm"][k], s) for k, s in zip(("h", "c", "n", "m"), blk["state"])]
            for mine, theirs in pairs:
                assert _same(mine, theirs), (kind, mine, theirs)
                compared += 1
        assert compared >= len(counts)
        # every port cache tensor but ``pos`` (replicated, P()) has a spec of its rank
        cache = M.init_cache(cfg, batch, max_len, "meta")
        assert [len(s) for s in _flat(port)] == [0 if t is cache["pos"] else t.dim() for t in _flat(cache)]
    assert all(tuple(s) == () for s in _flat(M.cache_specs(cfg, None, 8, 64)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_specs_align_with_defs(arch):
    """Every param gets a spec of matching rank; sharded dims divide evenly
    (twin of tests/test_sharding.py, on every arch)."""
    cfg = get_config(arch)
    defs = _flat(M.model_defs(cfg))
    specs = _flat(M.model_specs(cfg, MULTI))
    assert len(defs) == len(specs)
    for d, spec in zip(defs, specs):
        assert len(spec) <= len(d.shape)
        for dim, ax in zip(d.shape, tuple(spec) + (None,) * (len(d.shape) - len(spec))):
            if ax is None:
                continue
            size = 1
            for a in (ax,) if isinstance(ax, str) else ax:
                size *= MULTI.axis_size(a)
            assert dim % size == 0, (d.shape, spec)


def test_llama405b_fits_hbm_when_fully_sharded():
    """fp32 params + AdamW moments on 512 H100s leave room for activations."""
    cfg = get_config("llama3-405b")
    n = M.count_params_exact(cfg)
    per_card = n * (4 + 4 + 4) / 512
    assert per_card < H100_HBM_GB * 1e9 * 0.85
    # and the specs shard every matrix over the DP axes at least (8 kv heads
    # do not split over a 16-way model axis)
    specs = _flat(M.model_specs(cfg, MULTI))
    defs = _flat(M.model_defs(cfg))
    for d, spec in zip(defs, specs):
        if len(d.shape) >= 2:
            used = {a for e in spec for a in ((e,) if isinstance(e, str) else (e or ()))}
            assert {"pod", "data"} <= used, (d.shape, spec)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "mixtral-8x22b"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_resolve_moe_axes(arch, mesh, jax_rules):
    cfg = get_config(arch)
    got = resolve_moe_axes(cfg, ShardingRules(*MESHES[mesh]))
    assert got == jax_resolve_moe_axes(jax_get_config(arch), jax_rules[mesh])
    assert got == (arch == "moonshot-v1-16b-a3b")  # 64 experts shard over 16; mixtral's 8 do not
    assert resolve_moe_axes(cfg, None) is False


# --- specs on DTensor: placements ------------------------------------------------


def _mesh(names):
    return SimpleNamespace(mesh_dim_names=names)


def test_spec_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _mesh(("pod", "data", "model"))
    assert spec_placements(mesh, P(("pod", "data"), None, "model")) == [Shard(0), Shard(0), Shard(2)]
    assert spec_placements(mesh, P(None, "data")) == [Replicate(), Shard(1), Replicate()]
    assert spec_placements(mesh, P()) == [Replicate()] * 3
    # DTensor splits a dim over mesh dims in mesh order: refuse the other order
    with pytest.raises(AssertionError, match="mesh's axis order"):
        spec_placements(mesh, P(("data", "pod")))


def test_make_mesh_refuses_a_cpu_mesh_unasked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_mod.make_mesh((2, 4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_mod.parse_mesh_arg("2x16x16")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_mod.make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="axes"):
        mesh_mod.make_mesh((2, 4), ("data",), device="cpu")
    assert mesh_mod.DEFAULT_AXES[3] == ("pod", "data", "model")


@pytest.mark.parametrize("h,kh", [(6, 6), (6, 2), (8, 2)])
def test_padded_heads_preserve_attention(h, kh):
    """With rules, ``pad_attention_heads_to`` pads the head count to a
    multiple of the model axis with zero heads (MHA: q and kv heads
    together; GQA: extra groups) and cuts them off again: the output is
    the unpadded attention's."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 12, h, 16), generator=g)
    k, v = (torch.randn((2, 12, kh, 16), generator=g) for _ in range(2))
    plain = attn.multihead_attention(RunConfig(attention_impl="pallas"), q, k, v)
    run = RunConfig(attention_impl="pallas", pad_attention_heads_to=4)
    padded = attn._pad_heads(q, k, v, 4)[0]
    assert padded.shape[2] % 4 == 0 and padded.shape[2] >= h
    out = attn.multihead_attention(run, q, k, v, rules=SINGLE)
    assert out.shape == q.shape
    assert (out - plain).abs().max().item() < 1e-6
    # without rules the option changes nothing: the port pads only to shard
    assert torch.equal(attn.multihead_attention(run, q, k, v), plain)
