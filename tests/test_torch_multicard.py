"""``scripts/multicard_smoke.py`` rehearsed on 4 gloo CPU ranks.

The script's whole run (``multicard_smoke.run``: the dry-run's count and
the one-card references in processes of their own, then the ranks'
phases (a)-(e) and the comparison (f)) on ``rehearsal_plan()``:
qwen3-1.7b and moonshot-v1-16b-a3b cut to 2 layers of width 64, the plain
kernels, the same meshes ((1, 4), (4, 1), (2, 2)) and the same checks as
on four cards (``chip_smoke.check``: a failed one fails the run). One run
serves every test here. Nothing is timed: the figures that need a card
are absent.
"""

import os
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import multicard_smoke as S  # noqa: E402


@pytest.fixture(scope="module")
def record(tmp_path_factory):
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    plan = S.rehearsal_plan()
    return plan, S.run(plan, tmp_path_factory.mktemp("multicard"), timeout_s=300)


def test_k1_across_shards_matches_one_call(record):
    plan, rec = record
    d = rec["ranks"]["decode"]
    assert d["launches_per_rank"] == [1] * S.WORLD
    assert d["errors"]["vs_one_call"] < 1e-2 and d["errors"]["past_bf16_rounding"] <= 1e-4


def test_pipeline_matches_blocks_in_turn(record):
    plan, rec = record
    p = rec["ranks"]["pipeline"]
    assert p["max_abs_err"] == 0.0  # the same blocks on the same operands
    assert p["k2_launches_per_rank"] == [plan.pipe[0]] * S.WORLD
    assert p["bubble"] == 3 / 7


@pytest.mark.parametrize("phase", ["train", "train_moe"])
def test_sharded_train_losses_match_one_process(record, phase):
    plan, rec = record
    t = rec["ranks"][phase]
    one, sharded = t["one_card"]["losses"], t["sharded"]["losses"]
    assert len(sharded) == 1 + plan.train_steps
    np.testing.assert_allclose(sharded, one, rtol=1e-3)
    assert t["one_card"]["k2_and_dtensor_calls"][0][1] == 0


def test_fp32_cut_train_step_matches_one_process(record):
    assert record[1]["ranks"]["train"]["cut_fp32_max_param_err"] < 1e-4


def test_sharded_serve_matches_one_process(record):
    plan, rec = record
    s = rec["ranks"]["serve"]
    assert s["dense_cut_fp32"]["parts_at_step"] is None and s["dense_cut_fp32"]["max_abs_gap"] < 1e-4
    for key, steps in (("dense", plan.serve_steps), ("moe", plan.moe_serve_steps)):
        assert s[key]["compare"]["steps"] == steps
        assert len(s[key]["sharded"]["ms"]) == steps


def test_dryrun_counts_every_step(record):
    plan, rec = record
    rows = rec["dryrun_vs_measured"]
    assert set(rows) == {"train", "train_moe", "serve_prefill", "serve_decode", "serve_moe_prefill",
                         "serve_moe_decode"}
    for name, row in rows.items():
        assert row["counted_peak_gib"] > 0 and row["measured_peak_gib"] is None
        assert row["counted_collective_bytes_per_dev"] > 0, name
        assert rec["counts"][name]["n_devices"] == S.WORLD


@pytest.mark.parametrize("cards", [0, 3])
def test_refuses_without_four_cards(capsys, cards):
    with mock.patch.object(S.torch.cuda, "is_available", return_value=cards > 0), \
            mock.patch.object(S.torch.cuda, "device_count", return_value=cards):
        assert S.main([]) == 1
    assert f"needs 4 CUDA devices, one NCCL rank a card; this host has {cards}" in capsys.readouterr().err
