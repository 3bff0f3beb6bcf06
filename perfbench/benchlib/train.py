"""The training cell: the program's heterogeneous trainer
(``core/coordinator.py::HetCoordinator`` over ``launch/steps.py::
make_grad_step`` and ``optim/adamw.py``), built once in set-up as
``launch/train.py`` builds it, driven from the seed through its first
global steps, and handed as it is to the window.

The benchmark wraps the ``grad_fn`` and ``update_fn`` it hands the
coordinator: the first records each microbatch's loss, the second its
device span (CUDA events). Set-up reads the first steps' numbers that are
judged: each microbatch's loss, each leaf's first gradient as AdamW got
it (its first moment after one step over ``1 - beta1``), and each leaf's
change over the checked steps (against the weights made again from the
seed). After the window the reference follows those steps from the same
weights on the same microbatches.
"""

from __future__ import annotations

import gc
import time

import torch

from . import judge, program, traffic
from .serve import Timer, _sync
from .program_spans import SpanSlice


class Feed:
    """The microbatches of a run, in order, made on the device."""

    def __init__(self, mix: dict, seed: int, vocab: int, device):
        self.mix, self.seed, self.vocab, self.device, self.i = mix, seed, vocab, device, 0

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        b = traffic.microbatch(self.mix, self.seed, self.i, self.vocab, self.device)
        self.i += 1
        return b


def _norms(tensors) -> list[float]:
    return torch.stack([t.float().norm() for t in tensors]).tolist()


def run(cell, ref, phases) -> dict:
    cfg, mix, dev, seed, seconds = cell.cfg, cell.mix, cell.device, cell.seed, cell.seconds
    d = ref.dims(cfg)
    opt = mix["optimizer"]
    t = time.perf_counter()
    params = ref.make_params(cfg, seed, dev, torch.float32)
    _sync(dev)
    phases["weights_s"] = time.perf_counter() - t

    t = time.perf_counter()
    mcfg = program.model_config(cfg)
    coord, opt_state = program.trainer(mcfg, program.train_run(opt), params, mix)
    sl = SpanSlice(cell.trace)
    losses, updates = [], []
    grad0, update0 = coord.grad_fn, coord.update_fn

    def grad_fn(p, batch):
        with sl.span("bench.grad"):
            g, m = grad0(p, batch)
        losses.append(m["loss"])
        return g, m

    def update_fn(p, o, g):
        with sl.span("bench.update"):
            timer = Timer(dev)
            out = update0(p, o, g)
            updates.append(timer.stop())
        return out

    coord.grad_fn, coord.update_fn = grad_fn, update_fn
    feed = Feed(mix, seed, d.V, dev)
    mine = {}
    for step in range(1, mix["first_steps"] + 1):
        params, opt_state, _ = coord.step(params, opt_state, feed)
        if step == 1:
            mu = [t for _, t in ref.leaves_of(opt_state["mu"], d)]
            mine["grad_norms"] = [n / (1 - opt["beta1"]) for n in _norms(mu)]
        if step == mix["check_steps"]:
            start = ref.make_params(cfg, seed, dev, torch.float32)
            mine["change_norms"] = _norms([p - s for (_, p), (_, s) in zip(ref.leaves_of(params, d),
                                                                             ref.leaves_of(start, d))])
            del start
    mine["losses"] = [float(x) for x in losses[:mix["check_steps"] * mix["microbatches"]]]
    phases["first_steps_s"] = time.perf_counter() - t

    phases["setup_s"] = cell.clock()  # the window opens
    steps = []
    t_open = time.perf_counter()
    begin = t_open + mix["trace"]["start_frac"] * seconds
    while True:
        if steps and t_open + seconds - time.perf_counter() < steps[-1]["t1"] - steps[-1]["t0"]:
            break  # the next step would end after the close and not be counted
        if sl.enabled and sl.state == "before" and time.perf_counter() >= begin:
            sl.start()
            traced = 0
        t0 = time.perf_counter()
        n_upd = len(updates)
        params, opt_state, rep = coord.step(params, opt_state, feed)
        t1 = time.perf_counter()
        if sl.on:
            traced += 1
            if traced >= mix["trace"]["steps"]:
                sl.stop()
        if t1 - t_open > seconds:
            break  # completed after the close: not counted
        steps.append({"t0": t0 - t_open, "t1": t1 - t_open, "tokens": rep.tokens, "update": updates[n_upd]})
    if sl.on:
        sl.stop()
    phases["window_s"] = seconds
    phases["steps"] = len(steps)
    peak = torch.cuda.max_memory_allocated() if torch.device(dev).type == "cuda" else 0
    for s in steps:
        s["update_s"] = s.pop("update").seconds()
    data = {"seconds": seconds, "dims": d, "rows": mix["rows"], "seq": mix["seq"],
            "microbatches": mix["microbatches"], "steps": steps, "attempted": len(steps) * mix["microbatches"],
            "failed": 0, "slice": sl.summary, "memory_peak_bytes": peak}
    state = {"coord": coord, "params": params, "opt_state": opt_state}
    data["finish"] = lambda: _judge(cell, ref, state, mine)
    return data


def _judge(cell, ref, state, mine) -> dict:
    """Free the program's state, then follow the checked steps with the
    reference."""
    state.clear()
    gc.collect()
    if torch.device(cell.device).type == "cuda":
        torch.cuda.empty_cache()
    mix, d = cell.mix, ref.dims(cell.cfg)
    t = time.perf_counter()
    start = ref.make_params(cell.cfg, cell.seed, cell.device, torch.float32)
    refr = ref.train(cell.cfg, start, lambda i: traffic.microbatch(mix, cell.seed, i, d.V, cell.device)["tokens"],
                     mix["optimizer"], mix["check_steps"], mix["microbatches"])
    g = judge.train_gaps(mine, refr)
    g["reference_s"] = time.perf_counter() - t
    return g
