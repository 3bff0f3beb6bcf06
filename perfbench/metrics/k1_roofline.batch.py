"""k1_roofline.batch: K1's least time over its device time in the profiled
slice. The least time of each decode step and layer is the larger of the
operations and the bytes the valid keys need (``benchlib/counts.py::
k1_least_s``: q, the mask, the output, and the K and V of the valid keys
only), summed over the slice's decode steps and layers; the device time is
that of K1's kernels (``csrc/decode_attention.cu``: the split pass and the
combine) in the trace."""

from benchlib.counts import k1_least_s

KERNELS = ("::split_kernel", "::combine_kernel")


def read(data):
    s = data.get("slice")
    if not s or not data.get("slice_steps"):
        return None
    d = data["dims"]
    least = sum(d.L * k1_least_s(d, data["slots"], data["max_len"], n) for n in data["slice_steps"])
    spent = sum(t for name, t in s["kernels"].items() if any(k in name for k in KERNELS))
    return 100.0 * least / spent if spent else None
