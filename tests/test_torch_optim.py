"""The port's optimizer, gradient compression, checkpoints and data
pipeline (``repro_torch.optim``, ``repro_torch.checkpoint``,
``repro_torch.data.dataset``) against the JAX package on the same seeded
numpy inputs, and twins of the optimizer, int8 and checkpoint tests of
``tests/test_substrates.py``.

Tolerances: ``lr_schedule`` 1 fp32 ulp of the peak rate (both take the
cosine in fp32, each framework's own); AdamW params and moments 1e-6 over
three steps in fp32 (the same fp32 formula; the global norm is summed in
another leaf order), bf16 moments within one bf16 unit of the reference's;
int8 payloads, scales and residuals bit for bit (``torch.round`` and
``jnp.round`` both round half to even); batches bit for bit.
"""

import tempfile

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.checkpoint import CheckpointManager, latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.data.dataset import BlockDataset, SyntheticCorpus, batch_iterator
from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import adamw
from repro_torch.optim.compression import CompressedAllReduce, compress_int8, decompress_int8

try:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.data import dataset as jdataset
    from repro.optim import adamw as jadamw
    from repro.optim import compression as jcomp
except ImportError:  # the card's machine has no JAX
    jax = None

needs_jax = pytest.mark.skipif(jax is None, reason="JAX is not installed: the reference side is missing")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ----------------------------------------------------------------- optimizer vs the JAX package


@needs_jax
def test_lr_schedule_matches_reference_over_steps():
    run = RunConfig(learning_rate=3e-4, warmup_steps=20, total_steps=250)
    steps = np.arange(0, 301, dtype=np.int32)
    got = adamw.lr_schedule(run, torch.from_numpy(steps))
    exp = np.asarray(jadamw.lr_schedule(run, jnp.asarray(steps)))
    assert got.dtype == torch.float32
    ulp = np.spacing(np.float32(run.learning_rate))
    assert float(np.abs(got.numpy() - exp).max()) <= ulp


def _opt_inputs(rng, moments):
    shapes = {"w": (7, 5), "layers": [{"a": (3,), "b": (4, 2)}, {"a": (3,), "b": (4, 2)}]}
    np_params = tree_map(lambda s: rng.standard_normal(s).astype(np.float32), shapes, is_leaf=lambda x: isinstance(x, tuple))
    grads = [tree_map(lambda s: (rng.standard_normal(s) * 0.3).astype(np.float32), shapes,
                      is_leaf=lambda x: isinstance(x, tuple)) for _ in range(3)]
    return np_params, grads


@needs_jax
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(moments):
    """Three steps with the same gradients (clipping active on the first:
    the norm is scaled above grad_clip), fp32 params, moments in fp32 or
    bf16; the port updates in place and returns the same objects."""
    rng = np.random.default_rng(0)
    np_params, grads = _opt_inputs(rng, moments)
    grads[0] = tree_map(lambda g: g * 10, grads[0])
    run = RunConfig(learning_rate=1e-2, warmup_steps=2, total_steps=10, optimizer_dtype=moments)
    params = tree_map(lambda a: torch.from_numpy(a.copy()), np_params)
    state = adamw.init_opt_state(params, getattr(torch, moments))
    jparams = tree_map(jnp.asarray, np_params)
    jstate = jadamw.init_opt_state(jparams, getattr(jnp, moments))
    for g in grads:
        grads = tree_map(lambda a: torch.from_numpy(a.copy()), g)
        p_out, s_out, m = adamw.adamw_update(run, params, grads, state)
        assert all(np.array_equal(x.numpy(), y) for x, y in zip(tree_leaves(grads), tree_leaves(g)))
        assert p_out is params and s_out is state
        jparams, jstate, jm = jadamw.adamw_update(run, jparams, tree_map(jnp.asarray, g), jstate)
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= 1e-6 * float(jm["grad_norm"])
        assert float(m["lr"]) == float(jm["lr"])
    assert state["step"].dtype == torch.int32 and state["step"].shape == () and int(state["step"]) == 3
    for a, b in zip(tree_leaves(params), tree_leaves(jparams)):
        assert float(np.abs(_np(a) - _np(b)).max()) <= 1e-6
    for key in ("mu", "nu"):
        for a, b in zip(tree_leaves(state[key]), tree_leaves(jstate[key])):
            assert a.dtype == getattr(torch, moments)
            ref = _np(b)
            # fp32: the same formula; bf16: one bf16 unit (2^-7 relative)
            tol = 1e-6 * max(1.0, np.abs(ref).max()) if moments == "float32" else 2**-7 * np.abs(ref) + 1e-12
            assert np.all(np.abs(_np(a) - ref) <= tol)


@needs_jax
def test_compress_int8_bit_for_bit():
    rng = np.random.default_rng(1)
    for scale in (1e-3, 1.0, 50.0):
        x = (rng.standard_normal(1031) * scale).astype(np.float32)
        # values at halves of the quantizer's step, where the rounding rule shows
        x[:4] = np.float32([0.5, -0.5, 1.5, 2.5]) * (np.abs(x[4:]).max() / np.float32(127.0))
        q, s = compress_int8(torch.from_numpy(x))
        jq, js = jcomp.compress_int8(jnp.asarray(x))
        assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
        assert s.item() == float(js)
        assert np.array_equal(decompress_int8(q, s).numpy(), np.asarray(jcomp.decompress_int8(jq, js)))


@needs_jax
def test_compressed_all_reduce_bit_for_bit():
    """Two pods' error-feedback compressors over four steps: every payload,
    every residual and every weighted combine equal the reference's."""
    rng = np.random.default_rng(2)
    shapes = {"a": (33, 5), "layers": [{"w": (17,)}, {"w": (17,)}]}
    cars = [CompressedAllReduce() for _ in range(2)]
    jcars = [jcomp.CompressedAllReduce() for _ in range(2)]
    for _ in range(4):
        payloads, jpayloads = [], []
        for car, jcar in zip(cars, jcars):
            g = tree_map(lambda s: (rng.standard_normal(s) * 0.01).astype(np.float32), shapes,
                         is_leaf=lambda x: isinstance(x, tuple))
            payloads.append(car.encode(tree_map(torch.from_numpy, g)))
            jpayloads.append(jcar.encode(tree_map(jnp.asarray, g)))
            for r, jr in zip(tree_leaves(car._residual), tree_leaves(jcar._residual)):
                assert np.array_equal(r.numpy(), np.asarray(jr))
        for p, jp in zip(payloads, jpayloads):
            for (q, s), jq_js in zip(tree_leaves(p, is_leaf=lambda x: isinstance(x, tuple)),
                                     [jp["a"]] + [layer["w"] for layer in jp["layers"]]):
                assert np.array_equal(q.numpy(), np.asarray(jq_js[0])) and s.item() == float(jq_js[1])
        got = CompressedAllReduce.combine(payloads, [0.625, 0.375])
        exp = jcomp.CompressedAllReduce.combine(jpayloads, [0.625, 0.375])
        for a, b in zip(tree_leaves(got), tree_leaves(exp)):
            assert np.array_equal(a.numpy(), np.asarray(b))
    g = {"a": torch.zeros(100), "b": torch.zeros(28)}
    assert cars[0].compression_ratio(g) == pytest.approx(4 * 128 / (128 + 8))


@needs_jax
def test_batch_iterator_matches_reference():
    """Token batches, and a frontend's prefix features, bit for bit."""
    for arch, prefix in (("qwen3-1.7b-smoke", 0), ("llava-next-34b-smoke", 8)):
        it = batch_iterator(get_config(arch), 32, 3, seed=5, start_gid=2, frontend_prefix=prefix)
        jit = jdataset.batch_iterator(jax_get_config(arch), 32, 3, seed=5, start_gid=2, frontend_prefix=prefix)
        for _ in range(3):
            b, jb = next(it), next(jit)
            assert b.keys() == jb.keys()
            for key in b:
                assert b[key].dtype == jb[key].dtype and np.array_equal(b[key], jb[key])
        assert ("prefix_features" in b) == bool(prefix)


@needs_jax
def test_block_dataset_grains_match_reference():
    ds = BlockDataset(total_tokens=(1 << 26) + 5, block_bytes=32 << 20, grain_tokens=1 << 16)
    jds = jdataset.BlockDataset(total_tokens=(1 << 26) + 5, block_bytes=32 << 20, grain_tokens=1 << 16)
    assert (ds.total_bytes, ds.num_blocks, ds.grains_per_block) == (jds.total_bytes, jds.num_blocks,
                                                                    jds.grains_per_block)
    assert [(g.gid, g.nbytes, g.work) for g in ds.grains()] == [(g.gid, g.nbytes, g.work) for g in jds.grains()]


# ----------------------------------------------------------------- twins of tests/test_substrates.py


def test_corpus_deterministic_by_grain():
    c1 = SyntheticCorpus(256, 64, seed=7)
    c2 = SyntheticCorpus(256, 64, seed=7)
    assert np.array_equal(c1.grain_tokens(5, 4), c2.grain_tokens(5, 4))
    assert not np.array_equal(c1.grain_tokens(5, 4), c1.grain_tokens(6, 4))


def test_block_dataset_accounting():
    ds = BlockDataset(total_tokens=1 << 28, block_bytes=128 << 20, grain_tokens=1 << 18)
    assert ds.total_bytes == 1 << 30
    assert ds.num_blocks == 8
    grains = ds.grains()
    assert len(grains) == ds.num_blocks * ds.grains_per_block
    assert all(g.nbytes == (1 << 18) * 4 for g in grains)


@pytest.mark.parametrize("moments", [torch.float32, torch.bfloat16])
def test_adamw_converges_quadratic(moments):
    run = RunConfig(learning_rate=0.1, warmup_steps=5, total_steps=200, weight_decay=0.0, grad_clip=10.0)
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    opt = adamw.init_opt_state(params, moments)
    for _ in range(200):
        grads = {"w": params["w"] - target}
        params, opt, _ = adamw.adamw_update(run, params, grads, opt)
    assert float((params["w"] - target).abs().max()) < 1e-2


def test_lr_schedule_shape():
    run = RunConfig(learning_rate=1.0, warmup_steps=10, total_steps=110)
    lrs = [float(adamw.lr_schedule(run, torch.tensor(s, dtype=torch.int32))) for s in [0, 5, 10, 60, 110]]
    assert lrs[0] == 0.0 and lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0)
    assert lrs[2] > lrs[3] > lrs[4] >= 0.099


def test_grad_clip():
    g = {"a": torch.full((4,), 100.0)}
    clipped, norm = adamw.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(200.0)
    assert float(adamw.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)


@given(st.integers(0, 2**32 - 1))
@settings(max_examples=30, deadline=None)
def test_int8_roundtrip_bounded_error(seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(257) * rng.uniform(0.01, 10))
    q, scale = compress_int8(x)
    err = (decompress_int8(q, scale) - x).abs().max()
    # half-ULP of the quantizer, + fp32 rounding slack on x/scale
    assert float(err) <= float(scale) / 2 * (1 + 1e-5)


def test_error_feedback_preserves_signal():
    """With EF, the *cumulative* compressed sum tracks the true sum — the
    quantizer bias does not accumulate."""
    rng = np.random.default_rng(0)
    car = CompressedAllReduce()
    true_sum = torch.zeros(64, dtype=torch.float64)
    dec_sum = torch.zeros(64)
    for _ in range(50):
        g = {"w": torch.from_numpy(rng.standard_normal(64) * 0.01)}
        payload = car.encode(g)
        dec = CompressedAllReduce.combine([payload], [1.0])
        true_sum = true_sum + g["w"]
        dec_sum = dec_sum + dec["w"]
    drift = float((dec_sum - true_sum).abs().max())
    # residual carries at most one step's quantization error
    assert drift < 5e-4


def _state():
    return {
        "params": {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
                   "e": torch.ones((5, 3), dtype=torch.bfloat16) * 1.5,
                   "layers": [{"a": torch.full((3,), 2.0)}, {"a": torch.full((3,), -0.25)}]},
        "opt": {"m": torch.zeros((8, 8)), "step": torch.tensor(7, dtype=torch.int32)},
    }


def _assert_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)


@pytest.mark.parametrize("red", ["replicate", "stripe"])
def test_checkpoint_roundtrip_with_node_loss(red):
    state = _state()
    template = tree_map(torch.zeros_like, state)
    with tempfile.TemporaryDirectory() as d:
        cm = CheckpointManager(d, num_nodes=5, num_shards=8, redundancy=red, replication=3, stripe_k=4)
        cm.save(3, state)
        got, info = cm.restore(3, template, failed_nodes={"node2"})
        _assert_equal(state, got)
        assert info["step"] == 3


def test_checkpoint_replicate_survives_two_nodes_stripe_does_not_always():
    state = _state()
    template = tree_map(torch.zeros_like, state)
    with tempfile.TemporaryDirectory() as d:
        cm = CheckpointManager(d, num_nodes=5, num_shards=8, redundancy="replicate", replication=3)
        cm.save(1, state)
        got, _ = cm.restore(1, template, failed_nodes={"node0", "node1"})
        _assert_equal(state, got)


def test_checkpoint_async_and_latest():
    """An async save snapshots the state when it is called: an in-place
    update right after it does not reach the checkpoint."""
    state = _state()
    saved = tree_map(torch.clone, state)
    template = tree_map(torch.zeros_like, state)
    with tempfile.TemporaryDirectory() as d:
        cm = CheckpointManager(d, num_nodes=3, num_shards=4, async_save=True)
        cm.save(10, state)
        state["params"]["w"].add_(1.0)
        cm.save(20, state)  # implicitly joins the first
        cm.wait()
        assert cm.steps() == [10, 20]
        got, _ = cm.restore(10, template)
        _assert_equal(saved, got)
        got, _ = cm.restore(20, template)
        _assert_equal(state, got)
        assert latest_step(d, num_nodes=3) == 20


def test_stripe_survives_any_single_node_loss():
    """Regression: parity once shared a node with a group member, so losing
    that node killed shard+parity together."""
    state = _state()
    template = tree_map(torch.zeros_like, state)
    with tempfile.TemporaryDirectory() as d:
        cm = CheckpointManager(d, num_nodes=5, num_shards=8, redundancy="stripe", stripe_k=4)
        cm.save(1, state)
        for n in range(5):
            got, _ = cm.restore(1, template, failed_nodes={f"node{n}"})
            _assert_equal(state, got)


def test_checkpoint_module_functions_and_leaf_order():
    """save/restore through the module functions; the leaf order is the
    sorted-key order, whatever order the dicts were built in."""
    state = _state()
    shuffled = {"opt": {"step": state["opt"]["step"], "m": state["opt"]["m"]}, "params": state["params"]}
    assert [t.data_ptr() for t in tree_leaves(state)] == [t.data_ptr() for t in tree_leaves(shuffled)]
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 4, shuffled, num_nodes=4, num_shards=3)
        got, info = restore_checkpoint(d, 4, tree_map(torch.zeros_like, state), num_nodes=4, num_shards=3)
        _assert_equal(state, got)
        assert info["recovery_reads"] == 3
    leaves = tree_leaves(state)
    assert tree_leaves(tree_unflatten(state, leaves)) == leaves
    with pytest.raises(ValueError):
        tree_unflatten(state, leaves + [leaves[0]])
