"""The port's distribution layer on gloo CPU process groups, against the
JAX package and the port in one process.

One spawn of 8 ranks (``tests/torch_parallel_worker.py``, a ``file://``
rendezvous under ``tmp_path``, a wall-clock limit) runs every multi-rank
check; the JAX references are computed here while it runs:

* ``sharded_decode_attention`` on a (2, 4) mesh, B, S, H, KH, D = 4, 256, 8,
  2, 64 (the inputs of ``tests/test_distributed.py``), both paths within
  1e-5 of ``repro.kernels.ref.decode_attention_ref``; with a row that has
  no valid key, exact zeros on the kernel path (K1's contract) and the
  reference's uniform spread on the jnp path, and a row whose valid keys lie
  in one shard; and the K1 wrapper on head-sharded DTensors;
* ``pipeline_apply`` on a ("pod", "data") (4, 2) mesh within 1e-6 of the
  sequential run (twin of ``tests/test_pipeline.py``);
* the sharded train step of internlm2-1.8b cut to 2 layers, d_model 64,
  vocab 64, fp32, on (2, 4): loss, grad norm and every param within 1e-4
  of the port's one-process step and of the JAX package's one-device
  ``make_train_step(cfg, run, None)`` on the same weights (twin of
  ``tests/test_distributed.py::test_sharded_train_step_matches_single_device``);
* the forward loss with rules of moonshot-v1-16b-a3b-smoke,
  xlstm-1.3b-smoke and internlm2-1.8b-smoke with 6 q heads (padded to 8
  by ``pad_attention_heads_to``) within 1e-4 of the loss without rules
  (the MoE, mLSTM and sLSTM paths, K3's DTensor path, the padded heads);
* the sharded serve steps (``make_prefill_step``/``make_serve_step`` and
  ``decode_step`` with rules) on (2, 4), the cache's sequence over the
  4-way model axis: the train-step cut (prefill of 4 prompts, 6 greedy
  decode steps) against the port's one-process steps and the JAX
  package's ``prefill``/``decode_step(..., rules=None)`` on the same
  weights, logits within 1e-4 and greedy tokens identical, K1 through
  ``sharded_decode_attention``; a parked row whose cache is left bit for
  bit; a sliding-window ring that wraps; the einsum path's all-invalid
  row spread uniformly as the reference's (C3); and xlstm-, jamba- and
  moonshot-smoke decoding with rules as without, parked rows' states
  left bit for bit;
* the sharded ``lm_loss`` on (2, 4), the logits' sequence over ``model``
  (sequence parallelism) and their vocabulary over it (without), labels
  in every vocab shard and two positions masked: loss, ce and z-loss
  within 1e-6 (relative) of the port's one-process ``lm_loss`` and the JAX
  package's, d(logits) within 1e-5 of the largest;
* moonshot-v1-16b-a3b-smoke's ``moe_apply`` with rules on (2, 4), each
  data rank routing its own groups (training, inference, and 6 experts
  that the model axis does not divide, at a capacity factor that drops
  pairs): every rank's experts, queue positions and keep masks equal to
  the one-process ``route``'s of its groups; y, ``moe_aux`` and
  ``moe_drop_frac`` within 1e-6 of the largest |y|, the gradients of x and
  of each weight within 1e-5 of their largest.

In one process: each sequence shard's K1 partials against the JAX
package's ``decode_attention(..., return_partials=True, interpret=True)``,
``bubble_fraction``, and the combine of shards against one call. The
``gpu``-marked tests run K1 shard by shard against one K1 call on a card,
and every multi-rank case above on 4 NCCL ranks, one a card (the worker's
``BACKENDS["nccl"]`` meshes), against the port in one process on one card
(``test_every_case_on_four_nccl_ranks``; it skips on fewer than 4 cards).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parallel_worker as W
from repro_torch import bridge
from repro_torch.configs.base import RunConfig as PortRunConfig
from repro_torch.kernels import ops
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as M
from repro_torch.models.common import tree_leaves
from repro_torch.parallel.pipeline import bubble_fraction

try:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.configs.base import RunConfig as JaxRunConfig
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.launch import steps as jsteps
    from repro.models import model as JM
    from repro.optim import adamw as jadamw
except ImportError:  # the card's machine has no JAX: only the gpu test runs there
    jax = None

ROOT = Path(__file__).resolve().parents[1]
SPAWN_LIMIT_S = 300


def _jax_serve(case: str, jparams):
    """The JAX package's prefill and greedy decode_step (no rules, the
    einsum decode) for a serve case of the train-step cut: logits and
    tokens of every step."""
    _, window, _, _ = W.SERVE_CASES[case]
    jcfg = jax_get_config("internlm2-1.8b").reduced(num_layers=2, d_model=64, vocab_size=64, param_dtype="float32",
                                                    compute_dtype="float32", sliding_window=window)
    jrun = JaxRunConfig(attention_impl="xla", decode_attention_impl="einsum")
    _, _, _, prompts, active = W.serve_setup(case, {})
    logits, cache = JM.prefill(jcfg, jrun, jparams, jnp.asarray(prompts), W.SERVE_MAX_LEN)
    out = {"logits": [np.asarray(logits)], "tokens": []}
    for act in active:
        tok = out["logits"][-1].argmax(-1)
        out["tokens"].append(tok)
        logits, cache = JM.decode_step(jcfg, jrun, jparams, cache, jnp.asarray(tok), None,
                                       None if act is None else jnp.asarray(act))
        out["logits"].append(np.asarray(logits))
    return out


def _needs_jax():
    if jax is None:
        pytest.skip("JAX is not installed: the reference side of this test is missing")


def _jax_train_start():
    """The JAX package's weights and AdamW state for the train-step cut, and
    the same as the port's trees."""
    cfg, _ = W.train_setup()
    jcfg = jax_get_config("internlm2-1.8b").reduced(num_layers=2, d_model=64, vocab_size=64,
                                                    param_dtype="float32", compute_dtype="float32")
    jparams = JM.init_model(jax.random.PRNGKey(0), jcfg)
    jopt = jadamw.init_opt_state(jparams)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    port = {"params": bridge.params_from_jax(to_np(jparams), cfg), "opt": bridge.opt_state_from_jax(to_np(jopt), cfg)}
    return jcfg, jparams, jopt, port


def _port_loss(device: str):
    """``lm_loss`` of the loss case in one process, the port's on
    ``device``: the metrics and d(logits)."""
    logits, labels, mask = (torch.from_numpy(a).to(device) for a in W.loss_inputs())
    lg = logits.requires_grad_()
    total, metrics = M.lm_loss(W.train_setup()[0], PortRunConfig(), lg, labels, mask, {})
    (grad,) = torch.autograd.grad(total, [lg])
    return {k: v.item() for k, v in metrics.items()}, grad.cpu().numpy()


def _one_process_losses() -> dict:
    """``lm_loss`` of the loss case in one process, the port's and the JAX
    package's: the metrics and d(logits) of each."""
    logits, labels, mask = W.loss_inputs()

    def loss(x):
        return JM.lm_loss(None, JaxRunConfig(), x, jnp.asarray(labels), jnp.asarray(mask), {})

    (_, jmetrics), jgrad = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(logits))
    return {"port": _port_loss("cpu"), "jax": ({k: float(v) for k, v in jmetrics.items()}, np.asarray(jgrad))}


def _decode_ref(q, k, v, valid) -> np.ndarray:
    """The reference's decode attention in float64 numpy: scores of invalid
    keys at -1e30, so a row with no valid key spreads uniformly (C3)."""
    b, h, d = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, kh, h // kh, d).astype(np.float64)
    s = np.einsum("bhgd,bkhd->bhgk", qg, k.astype(np.float64)) / np.sqrt(d)
    s = np.where(valid[:, None, None, :], s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhgk,bkhd->bhgd", p, v.astype(np.float64)).reshape(b, h, d)


def _port_refs(device: str, start: dict, cut_params: dict) -> dict:
    """The port in one process on ``device`` (no rules) on the workers'
    inputs: the train step from ``start``, the forward losses, the loss
    case, the MoE cases, the serve cases (the cut on ``cut_params``) and
    the pipeline run stage after stage."""
    ref = {}
    cfg, run = W.train_setup(device)
    batch = W.train_batch()
    p1, o1, m1 = make_train_step(cfg, run)(W.to_device(start["params"], device), W.to_device(start["opt"], device),
                                           batch)
    ref["port_train"] = (W.to_device(p1, "cpu"), W.to_device(o1["mu"], "cpu"), {k: v.item() for k, v in m1.items()})
    for arch in W.FWD_ARCHS:
        ref[f"forward/{arch}"] = W.fwd_loss(*W.fwd_setup(arch, device)).item()
    ref["loss/port"] = _port_loss(device)
    for case in W.MOE_CASES:
        _, mparams, x, w = W.moe_setup(case)
        ref[f"moe/{case}"] = W.moe_run(case, *W.to_device((mparams, x, w), device))
    for case in W.SERVE_CASES:
        ref[f"serve/{case}"] = W.serve(*W.serve_setup(case, cut_params, device))
    w, x = (torch.from_numpy(a).to(device) for a in W.pipe_inputs())
    for s in range(w.shape[0]):
        x = torch.tanh(x @ w[s])
    ref["pipeline"] = x.cpu()
    return ref


def _spawn(out: Path, backend: str) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT / 'tests'}", OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_parallel_worker.py"), str(out), backend],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _wait(proc: subprocess.Popen, out: Path) -> dict:
    try:
        _, err = proc.communicate(timeout=SPAWN_LIMIT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-4000:]
    return torch.load(out / "results.pt", weights_only=False)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start the 8 gloo ranks, compute the references while they run, and
    return ``(rank 0's results, references)``."""
    _needs_jax()
    out = tmp_path_factory.mktemp("gloo")
    jcfg, jparams, jopt, start = _jax_train_start()
    torch.save(start, out / "train_in.pt")
    proc = _spawn(out, "gloo")
    try:
        ref = {}
        for case in ("random", "edge"):
            q, k, v, valid = W.decode_inputs(case)
            ref[f"decode/{case}"] = np.asarray(jref.decode_attention_ref(q, k, v, valid))
        # the one-device JAX step and the port's one-process step on the same weights
        batch = W.train_batch()
        jrun = JaxRunConfig(remat="none", attention_impl="chunked", attention_chunk=16, z_loss=0.0)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        jp, _, jm = jax.jit(jsteps.make_train_step(jcfg, jrun, None))(jparams, jopt, jbatch)
        ref["jax_train"] = (bridge.params_from_jax(jax.tree.map(np.asarray, jp), W.train_setup()[0]),
                            {k: float(v) for k, v in jm.items()})
        ref["loss"] = _one_process_losses()
        cut_params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), W.train_setup()[0])
        ref.update(_port_refs("cpu", start, cut_params))
        for case in W.SERVE_CASES:
            if W.SERVE_CASES[case][0] == "cut" and case != "cut/parked":
                ref[f"jax_serve/{case}"] = _jax_serve(case, jparams)
    except BaseException:
        proc.kill()
        raise
    return _wait(proc, out), ref


# --- multi-rank -------------------------------------------------------------------
# Each check takes rank 0's results and the references, so that the gloo
# tests and the NCCL test on the cards hold the same things.


def _check_mesh(res):
    main = res["meshes"]["main"]
    assert res["mesh"] == (("data", "model"), main, ("data", "model"))


def test_mesh_on_gloo(ranks):
    res, _ = ranks
    assert res["meshes"]["main"] == (2, 4)
    _check_mesh(res)


def _check_decode(res, ref, use_kernel):
    out, placements = res[f"decode/random/{use_kernel}"]
    assert placements == [0, "R"]  # batch over data, replicated over model
    err = (out.numpy() - ref["decode/random"]).__abs__().max()
    assert err < 1e-5, err


@pytest.mark.parametrize("use_kernel", [True, False])
def test_sharded_decode_matches_ref(ranks, use_kernel):
    _check_decode(*ranks, use_kernel)


def _check_decode_edge(res, ref):
    exp = ref["decode/edge"]
    kern = res["decode/edge/True"][0].numpy()
    jnp_path = res["decode/edge/False"][0].numpy()
    assert np.all(kern[0] == 0.0)
    assert np.abs(kern[1:] - exp[1:]).max() < 1e-5
    assert np.abs(jnp_path - exp).max() < 1e-5
    # the reference's row 0: each head the mean value of its kv head (G = 4)
    v = W.decode_inputs("edge")[2]
    assert np.abs(exp[0] - np.repeat(v[0].mean(axis=0), 4, axis=0)).max() < 1e-5


def test_sharded_decode_empty_rows_follow_each_paths_contract(ranks):
    """Row 0 has no valid key: zeros on the kernel path, the reference's
    uniform spread on the jnp path. Row 3's valid keys lie in shard 0 only:
    the three empty shards weigh nothing."""
    _check_decode_edge(*ranks)


def _check_decode_wrapper(res, kh, device="cpu"):
    out, placements, inputs = res[f"decode_wrapper/{kh}"]
    assert placements == [0, 1]  # batch over data, heads over model
    exp = ops.decode_attention(*W.to_device(inputs, device)).cpu()
    assert (out - exp).abs().max().item() < 1e-6


@pytest.mark.parametrize("kh", [2, 8])
def test_decode_wrapper_on_head_sharded_dtensors(ranks, kh):
    """``ops.decode_attention`` on DTensors with q's 8 heads over the 4-way
    model axis: 2 kv heads stay replicated and each rank reads the one its
    q heads pair with; 8 kv heads split as q's do. Against the wrapper on
    the whole tensors in one process."""
    _check_decode_wrapper(ranks[0], kh)


def test_sharded_decode_rejects_an_uneven_split(ranks):
    res, _ = ranks
    assert "does not divide" in res["decode/indivisible"]


def _check_pipeline(res, ref):
    err = (res["pipeline"] - ref["pipeline"]).abs().max().item()
    assert err < 1e-6, err


def test_pipeline_matches_sequential(ranks):
    _check_pipeline(*ranks)


def _max_err(a_tree, b_tree):
    return max((a - b).abs().max().item() for a, b in zip(tree_leaves(a_tree), tree_leaves(b_tree)))


def _check_train(res, ref):
    p1, mu1, m1 = ref["port_train"]
    got = res["train"]
    assert got["placements"] == [0, 1]  # wq (D, H, hd): fsdp over data, heads over model
    assert abs(got["metrics"]["loss"] - m1["loss"]) < 1e-4
    assert abs(got["metrics"]["grad_norm"] - m1["grad_norm"]) < 1e-4 * m1["grad_norm"]
    assert _max_err(got["params"], p1) < 1e-4
    assert _max_err(got["mu"], mu1) < 1e-4 * max(t.abs().max().item() for t in tree_leaves(mu1))


def test_sharded_train_step_matches_one_process_step(ranks):
    _check_train(*ranks)


def test_sharded_train_step_matches_jax(ranks):
    res, ref = ranks
    jp, jm = ref["jax_train"]
    got = res["train"]
    assert abs(got["metrics"]["loss"] - jm["loss"]) < 1e-4
    assert abs(got["metrics"]["grad_norm"] - jm["grad_norm"]) < 1e-4 * jm["grad_norm"]
    assert _max_err(got["params"], jp) < 1e-4


def _check_forward(res, ref, arch):
    assert abs(res[f"forward/{arch}"] - ref[f"forward/{arch}"]) < 1e-4


@pytest.mark.parametrize("arch", list(W.FWD_ARCHS))
def test_forward_with_rules_matches_without(ranks, arch):
    _check_forward(*ranks, arch)


def _logit_tol(case: str, ref_logits) -> float:
    """1e-4, of the largest |logit| for the smoke configs: the sharded
    projections sum in another order, and the random-weight xLSTM stack
    carries that up to 3e-5 of the largest logit into its logits in fp32."""
    return 1e-4 if case.startswith("cut") else 1e-4 * max(1.0, max(float(np.abs(x).max()) for x in ref_logits))


def _check_serve(res, ref, case):
    got, exp = res[f"serve/{case}"], ref[f"serve/{case}"]
    tol = _logit_tol(case, [t.numpy() for t in exp["logits"]])
    for step, (a, b) in enumerate(zip(got["logits"], exp["logits"])):
        assert (a - b).abs().max().item() < tol, (step, (a - b).abs().max().item())
    assert all(torch.equal(a, b) for a, b in zip(got["tokens"], exp["tokens"]))


@pytest.mark.parametrize("case", list(W.SERVE_CASES))
def test_sharded_serve_matches_one_process(ranks, case):
    _check_serve(*ranks, case)


@pytest.mark.parametrize("case", ["cut", "cut/window", "cut/einsum"])
def test_sharded_serve_matches_jax(ranks, case):
    """Against the JAX package's prefill and decode_step without rules on
    the same weights. ``cut/einsum`` parks row 1 from the first step: it
    has no valid key, and both spread its attention uniformly over the
    cache (C3); the JAX package writes no slot for it either (its parked
    row's slot is -1 outside a window)."""
    res, ref = ranks
    got, exp = res[f"serve/{case}"], ref[f"jax_serve/{case}"]
    for step, (a, b) in enumerate(zip(got["logits"], exp["logits"])):
        assert np.abs(a.numpy() - b).max() < 1e-4, (step, np.abs(a.numpy() - b).max())
    assert all(np.array_equal(a.numpy(), b) for a, b in zip(got["tokens"], exp["tokens"]))


def _check_serve_k1(res):
    got = res["serve/cut"]
    assert got["placements"]["k"] == [1, 2] and got["placements"]["pos"] == ["R", "R"]
    assert got["sharded_decode_calls"] == [True] * (2 * W.SERVE_STEPS)
    assert res["serve/cut/einsum"]["sharded_decode_calls"] == [False] * (2 * W.SERVE_STEPS)


def test_sharded_serve_runs_k1_over_sequence_shards(ranks):
    """The cache (L, B, cap, KH, hd) has its batch over ``data`` and its
    sequence over ``model``; every attention layer of every decode step
    runs K1 through ``sharded_decode_attention`` (the einsum path through
    its jnp partials)."""
    _check_serve_k1(ranks[0])


def _rows(tree, row: int) -> list:
    """Row ``row`` of every stacked cache tensor (batch on dim 1; pos on dim 0)."""
    return [t[row] if t.dim() == 1 else t[:, row] for t in tree_leaves(tree)]


def _check_parked(res, case):
    got = res[f"serve/{case}"]
    parked = W.SERVE_CASES[case][3]  # caches[i]: after the prefill (0) and after each step
    before, after = got["caches"][parked], got["caches"][-1]
    assert all(torch.equal(a, b) for a, b in zip(_rows(before, 1), _rows(after, 1)))
    assert not all(torch.equal(a, b) for a, b in zip(_rows(before, 0), _rows(after, 0)))


PARKED_CASES = [c for c, v in W.SERVE_CASES.items() if v[3] == 2]


@pytest.mark.parametrize("case", PARKED_CASES)
def test_sharded_serve_parked_row_untouched(ranks, case):
    """Row 1 is parked from the second decode step on: its position, KV
    slots and recurrent state (every shard of them) keep their bits."""
    _check_parked(ranks[0], case)


def _check_loss(res, metrics, grad, sp):
    got = res[f"loss/sp={sp}"]
    assert got["layout"] == ([0, 1] if sp else [0, 2])  # batch over data; sequence or vocab over model
    for key in ("loss", "ce", "z_loss"):
        assert abs(got["metrics"][key] - metrics[key]) <= 1e-6 * abs(metrics[key]), (key, got["metrics"], metrics)
    assert metrics["z_loss"] > 0
    err = np.abs(got["grad"].numpy() - grad).max()
    assert err <= 1e-5 * np.abs(grad).max(), err


@pytest.mark.parametrize("sp", [True, False], ids=["sequence_on_model", "vocab_on_model"])
@pytest.mark.parametrize("against", ["port", "jax"])
def test_sharded_lm_loss_matches_one_process(ranks, sp, against):
    """Each rank takes its own (batch, sequence, vocab) block; the row
    statistics are reduced over the vocab's mesh dim where it is split,
    the masked sums over the rows' dims."""
    res, ref = ranks
    _check_loss(res, *ref["loss"][against], sp)


def _check_moe_routing(res, ref, case):
    (top_i, pos, keep, cap), = ref[f"moe/{case}"]["routing"]
    per_rank = top_i.shape[0] // res["meshes"]["moe"][0]  # groups a data rank holds
    seen = set()
    for (data, model), routing in res[f"moe/{case}"]["routing"]:
        (r_i, r_pos, r_keep, r_cap), = routing
        mine = slice(data * per_rank, (data + 1) * per_rank)
        assert r_cap == cap
        assert torch.equal(r_i, top_i[mine]) and torch.equal(r_pos, pos[mine]) and torch.equal(r_keep, keep[mine])
        seen.add((data, model))
    assert len(seen) == res["world"]
    if case == "train/e6":
        assert not keep.all()  # the capacity factor drops pairs


@pytest.mark.parametrize("case", list(W.MOE_CASES))
def test_sharded_moe_routes_each_ranks_own_groups(ranks, case):
    """Every rank routed the groups of its data rank's batch rows: experts,
    queue positions, keep masks and capacity exactly the one-process
    routing's of those groups (a group never crosses a sequence)."""
    _check_moe_routing(*ranks, case)


def _check_moe(res, ref, case):
    got, exp = res[f"moe/{case}"], ref[f"moe/{case}"]
    assert got["expert_layout"] == ([1, 0] if case != "train/e6" else [1, "R"])  # fsdp over data; experts over model
    scale = exp["y"].abs().max().item()
    assert (got["y"] - exp["y"]).abs().max().item() <= 1e-6 * scale
    for key in ("moe_aux", "moe_drop_frac"):
        assert abs(got["aux"][key] - exp["aux"][key]) <= 1e-6 * scale, (key, got["aux"], exp["aux"])
    for a, b in zip(got["grads"], exp["grads"]):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


@pytest.mark.parametrize("case", list(W.MOE_CASES))
def test_sharded_moe_matches_one_process(ranks, case):
    """y, the aux metrics and the gradients of x and of every weight, with
    the experts over ``model`` (4 experts) or their slots (6)."""
    _check_moe(*ranks, case)


# --- one process ------------------------------------------------------------------


def test_bubble_fraction():
    assert bubble_fraction(1, 8) == 0.0
    assert bubble_fraction(4, 4) == 3 / 7
    assert bubble_fraction(2, 30) == 1 / 31
    assert bubble_fraction(4, 32) < bubble_fraction(4, 4)


@pytest.mark.parametrize("case", ["random", "edge"])
def test_local_partials_match_jax_kernel(case):
    """Each of 4 sequence shards' K1 partials (the plain version here)
    against the JAX package's Pallas kernel in interpret mode on the same
    shard; and the one-process combine of the shards against one call."""
    _needs_jax()
    q, k, v, valid = W.decode_inputs(case)
    n = 4
    step = k.shape[1] // n
    outs, ms, ls = [], [], []
    for i in range(n):
        sl = slice(i * step, (i + 1) * step)
        acc, m, l = ops.decode_attention(*(torch.from_numpy(a) for a in (q, k[:, sl], v[:, sl], valid[:, sl])),
                                         return_partials=True)
        jacc, jm, jl = (np.asarray(t) for t in jops.decode_attention(
            q, k[:, sl], v[:, sl], valid[:, sl], return_partials=True, interpret=True))
        live = jl > 0  # a row with no valid key: both give zero weight (l = 0, acc = 0)
        np.testing.assert_allclose(l.numpy(), jl, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(acc.numpy(), jacc, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(m.numpy()[live], jm[live], rtol=1e-5, atol=1e-5)
        assert np.all(acc.numpy()[~live] == 0.0)
        outs.append(acc), ms.append(m), ls.append(l)
    whole = ops.decode_attention(*(torch.from_numpy(a) for a in (q, k, v, valid)))
    combined = ops.combine_decode_partials(outs, ms, ls)
    assert (combined - whole).abs().max().item() < 1e-5


# --- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_shard_by_shard_matches_one_call(cuda, dtype):
    """Part (a) of chip_smoke.py's distribution phase at a small size: K1
    with partials on each of 4 sequence shards, combined, against one K1
    call over the whole cache; an all-invalid row and one valid in shard 0
    only included."""
    B, S, H, KH, D = 4, 2048, 16, 8, 128
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((B, H, D), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, S, KH, D), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, S, KH, D), generator=g, device=cuda).to(dtype)
    valid = torch.rand((B, S), generator=g, device=cuda) > 0.2
    valid[0] = False
    valid[3, S // 4:] = False
    whole = ops.decode_attention(q, k, v, valid).float()
    step = S // 4
    parts = [ops.decode_attention(q, k[:, i * step:(i + 1) * step], v[:, i * step:(i + 1) * step],
                                  valid[:, i * step:(i + 1) * step], return_partials=True) for i in range(4)]
    combined = ops.combine_decode_partials(*zip(*parts))
    assert torch.all(combined[0] == 0) and torch.all(whole[0] == 0)
    assert (combined - whole).abs().max().item() < (3e-2 if dtype == torch.bfloat16 else 1e-4)


@pytest.fixture(scope="module")
def nccl_ranks(tmp_path_factory):
    """The worker's cases on 4 NCCL ranks, one a card, and the port in one
    process on card 0 on the same inputs (computed while the ranks run):
    ``(rank 0's results, references)``. Skips on a host with fewer than 4
    cards."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 NVIDIA GPUs: one NCCL rank a card")
    out = tmp_path_factory.mktemp("nccl")
    start = W.port_train_start("cuda")  # the cut as the cards run it (heads of 64), made on the CPU
    torch.save(start, out / "train_in.pt")
    proc = _spawn(out, "nccl")
    try:
        torch.backends.cuda.matmul.allow_tf32 = False  # as the ranks run
        torch.backends.cudnn.allow_tf32 = False
        ref = {f"decode/{case}": _decode_ref(*W.decode_inputs(case)) for case in ("random", "edge")}
        ref.update(_port_refs("cuda", start, torch.load(out / "train_in.pt")["params"]))
        m, g = ref.pop("loss/port")
        ref["loss"] = {"port": (m, g)}
    except BaseException:
        proc.kill()
        raise
    return _wait(proc, out), ref


@pytest.mark.gpu
def test_every_case_on_four_nccl_ranks(nccl_ranks):
    """Every multi-rank case above on 4 NCCL ranks, one a card, on the
    meshes (2, 2), (4, 1) and (1, 4) (``BACKENDS["nccl"]``; the e6 MoE case
    keeps a 4-way model axis that does not divide its 6 experts), against
    the port in one process on one card with the same limits; the decode
    cases against the reference's formula in float64."""
    res, ref = nccl_ranks
    assert res["backend"] == "nccl" and res["world"] == 4
    _check_mesh(res)
    for use_kernel in (True, False):
        _check_decode(res, ref, use_kernel)
    _check_decode_edge(res, ref)
    for kh in (2, 8):
        _check_decode_wrapper(res, kh, "cuda")
    assert "does not divide" in res["decode/indivisible"]
    _check_pipeline(res, ref)
    _check_train(res, ref)
    for arch in W.FWD_ARCHS:
        _check_forward(res, ref, arch)
    for case in W.SERVE_CASES:
        _check_serve(res, ref, case)
    _check_serve_k1(res)
    for case in PARKED_CASES:
        _check_parked(res, case)
    for sp in (True, False):
        _check_loss(res, *ref["loss"]["port"], sp)
    for case in W.MOE_CASES:
        _check_moe_routing(res, ref, case)
        _check_moe(res, ref, case)
