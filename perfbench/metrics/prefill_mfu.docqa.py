"""prefill_mfu.docqa: the model FLOPs of the run's prefills, counted from
their shapes (``benchlib/counts.py::prefill_flops``), over their time by CUDA
events around each ``loop.prefill`` call, as a share of the H100's dense
bf16 peak."""

from benchlib.counts import BF16_FLOPS, prefill_flops


def read(data):
    if not data.get("prefills"):
        return None
    flops = sum(prefill_flops(data["dims"], p["s"]) for p in data["prefills"])
    secs = sum(p["seconds"] for p in data["prefills"])
    return 100.0 * flops / secs / BF16_FLOPS
