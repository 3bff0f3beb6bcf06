"""Fixtures of the benchmark's own tests: the harness's modules on the path,
the card where there is one, and cells cut to a size the CPU runs in
seconds (the same files, each configuration cut as its reference's
``tiny_cut()`` gives, the traffic and window made tiny)."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
for p in (HERE, HERE.parent / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the program's CUDA kernels have no CPU mode")
    return torch.device("cuda")


def tiny_config(cfg: dict, ref, fp32: bool = True) -> dict:
    """The configuration file ``cfg`` cut to the size its reference ``ref``
    gives for the CPU (``ref.tiny_cut()``); with ``fp32`` the program
    computes in float32, so that it agrees with the reference to
    round-off."""
    cfg = copy.deepcopy(cfg)
    keys, over = ref.tiny_cut()
    cfg.update(keys)
    over = dict(over, **({"compute_dtype": "float32"} if fp32 else {}))
    cfg["program"] = dict(cfg["program"], overrides=dict(cfg["program"].get("overrides", {}), **over))
    return cfg


def tiny(name: str, fp32: bool = True, seconds: float = 1.5, seed: int = 2**33 + 5):
    """The cell ``name`` cut to a CPU size: its configuration as
    :func:`tiny_config` cuts it, a few short requests or microbatches."""
    from benchlib import host, spec

    c = spec.resolve(name)
    cfg = tiny_config(c.cfg, c.ref, fp32)
    mix = copy.deepcopy(c.mix)
    if mix["kind"] == "open_loop":
        mix.update(slots=4, max_len=80, rate_per_s=4.0, drain_s=20)
        mix["prompt"] = dict(mix["prompt"], min=16, max=64)
        mix["output"] = dict(mix["output"], min=3, max=8)
        mix["check"] = dict(mix["check"], served_tokens=20)
    elif mix["kind"] == "closed_loop":
        mix.update(slots=4, clients=4, max_len=80, pool=64)
        mix["prompt"] = dict(mix["prompt"], min=16, max=48)
        mix["output"] = dict(mix["output"], min=4, max=16)
        mix["check"] = dict(mix["check"], served_tokens=30)
    else:
        mix.update(rows=2, seq=32, check_steps=2, first_steps=2)
    c.cfg, c.mix = cfg, mix
    c.device, c.clock, c.seed, c.seconds = "cpu", host.seconds_since_start, seed, seconds
    return c


@pytest.fixture
def tiny_cell():
    return tiny


@pytest.fixture
def tiny_cfg():
    return tiny_config
