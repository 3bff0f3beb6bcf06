"""k2_roofline.docqa8k: K2's least time over its device time in the profiled
slice, for a latent-attention model. The least time of each prefill layer
is the larger of its causal pairs' operations at the published head widths
over the bf16 peak and its unpadded q, k, v and output bytes over HBM
bandwidth (``metrics/mla_counts.py``), summed over the slice's prefills and
layers; the device time is that of K2's kernels (``csrc/flash_attention.cu``)
in the trace."""

from pathlib import Path

from benchlib.spec import load_module

counts = load_module(Path(__file__).resolve().parent / "mla_counts.py")
KERNELS = ("::flash_tc_kernel", "::flash_fp32_kernel")


def read(data):
    s = data.get("slice")
    if not s or not data.get("prefills"):
        return None
    d = data["dims"]
    least = sum(d.L * counts.k2_mla_least_s(d, p["s"]) for p in data["prefills"] if p["in_slice"])
    spent = sum(t for name, t in s["kernels"].items() if any(k in name for k in KERNELS))
    return 100.0 * least / spent if least and spent else None
