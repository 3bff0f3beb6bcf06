"""train_mfu.train: the model FLOPs of the window's global steps (6 N per
token and three times the forward's causal attention,
``benchlib/counts.py::train_flops``), over their time, as a share of the H100's
dense bf16 peak. K2's recomputed backward is not model work and is not
counted."""

from benchlib.counts import BF16_FLOPS, train_flops


def read(data):
    steps = data.get("steps") or []
    if not steps:
        return None
    grains = sum(s["tokens"] for s in steps) // (data["rows"] * data["seq"])
    secs = steps[-1]["t1"] - steps[0]["t0"]
    return 100.0 * grains * train_flops(data["dims"], data["rows"], data["seq"]) / secs / BF16_FLOPS
