"""What the benchmark takes from the program under test, ``repro_torch``
(``src/repro_torch``), in one place: its model configuration and the shapes
of its weights, its serving replica and request, its training step,
optimizer and heterogeneous coordinator, and its span recorder. Nothing
else of the program is imported, and nothing of the JAX package it was
ported from.
"""

from __future__ import annotations

import dataclasses
import importlib


def load() -> None:
    """Import every module of the program that a run uses (the set-up phase
    ``import_program_s``)."""
    import repro_torch.configs  # noqa: F401
    import repro_torch.core.coordinator  # noqa: F401
    import repro_torch.launch.serve  # noqa: F401
    import repro_torch.launch.steps  # noqa: F401
    import repro_torch.optim.adamw  # noqa: F401


def model_config(cfg: dict):
    """The program's ``ModelConfig`` for a configuration file: its preset
    with the file's ``program.overrides``."""
    from repro_torch.configs import get_config

    prog = cfg["program"]
    mcfg = dataclasses.replace(get_config(prog["preset"]), **prog.get("overrides", {}))
    mcfg.validate()
    return mcfg


# what every reference's program_sizes() states, so that an empty one cannot pass
REQUIRED_SIZES = ("num_layers", "d_model", "vocab_size")


def breaches(ref, cfg: dict) -> list[str]:
    """Where the program built from the configuration file ``cfg`` departs
    from what its plain reference ``ref`` states; empty where it departs in
    nothing. ``ref.program_sizes(cfg)`` names ``ModelConfig`` attributes
    with their values, and ``ref.leaf_paths(ref.dims(cfg))`` every weight
    with its shape: the program has to hold each size, and the weights of
    its model have to be those, leaf for leaf."""
    from repro_torch.models import model as M

    sizes = ref.program_sizes(cfg)
    out = [f"{k}: not stated" for k in REQUIRED_SIZES if k not in sizes]
    m = model_config(cfg)
    for k, v in sizes.items():
        have = getattr(m, k, "<none>")
        if have != v:
            out.append(f"{k}: the program has {have!r}, the file {v!r}")
    theirs = M.model_shapes(m)
    paths = ref.leaf_paths(ref.dims(cfg))
    for path, shape, _ in paths:
        node = theirs
        try:
            for key in path:
                node = node[key]
        except (KeyError, IndexError, TypeError):
            out.append(f"{'/'.join(map(str, path))}: no such weight in the program")
            continue
        if tuple(node.shape) != tuple(shape):
            out.append(f"{'/'.join(map(str, path))}: the program's {tuple(node.shape)}, the file's {tuple(shape)}")
    n = sum(1 for _ in _leaves(theirs))
    if n != len(paths):
        out.append(f"the program has {n} weights, the file {len(paths)}")
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def recorder():
    """The program's span recorder (``repro_torch.spans``), or ``None``
    where the program has none."""
    try:
        return importlib.import_module("repro_torch.spans")
    except ModuleNotFoundError:
        return None


def serve_run():
    """The run settings ``launch/serve.py::main`` serves with on the card:
    K2 for prefill, K1 for decode."""
    from repro_torch.configs.base import RunConfig

    return RunConfig(remat="none", attention_impl="pallas", decode_attention_impl="kernel")


def train_run(opt: dict):
    """The run settings ``launch/train.py::build_model`` trains with, the
    optimizer's numbers from the mix."""
    from repro_torch.configs.base import RunConfig

    return RunConfig(learning_rate=opt["lr"], total_steps=opt["total"], warmup_steps=opt["warmup"],
                     weight_decay=opt["weight_decay"], beta1=opt["beta1"], beta2=opt["beta2"], eps=opt["eps"],
                     grad_clip=opt["clip"], z_loss=opt["z_loss"], remat="none", attention_impl="pallas",
                     het_schedule=True, grad_compression="none")


def serve_loop(mcfg, params, slots: int, max_len: int, device):
    from repro_torch.launch.serve import ServeLoop

    return ServeLoop(mcfg, serve_run(), params, batch=slots, max_len=max_len, admission="admit_all",
                     mode="arena", warmup=True, device=device)


def request(rid: int, prompt, max_new: int, arrived: float):
    from repro_torch.launch.serve import Request

    return Request(rid, prompt, max_new, arrived=arrived)


def trainer(mcfg, run, params, mix: dict):
    """``(coordinator, opt_state)`` as ``launch/train.py::main`` builds them:
    AdamW state in float32, ``make_grad_step``, pods of ``mix["pods"]``
    speeds, ``mix["microbatches"]`` grains of ``rows x seq`` tokens a step."""
    import torch

    from repro_torch.core.coordinator import HetCoordinator, PodRuntime
    from repro_torch.launch.steps import make_grad_step
    from repro_torch.optim import adamw

    opt_state = adamw.init_opt_state(params, getattr(torch, run.optimizer_dtype))

    def update_fn(p, o, g):
        return adamw.adamw_update(run, p, g, o)

    pods = [PodRuntime(f"pod{i}", s) for i, s in enumerate(mix["pods"])]
    coord = HetCoordinator(grad_fn=make_grad_step(mcfg, run), update_fn=update_fn, pods=pods,
                           total_microbatches=mix["microbatches"], grain_tokens=mix["rows"] * mix["seq"],
                           compress=False, het_schedule=run.het_schedule)
    return coord, opt_state
