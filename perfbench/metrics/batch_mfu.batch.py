"""batch_mfu.batch: the model FLOPs of every token the window processed,
prompt tokens of the prefills started in it and decoded tokens emitted in
it (each with attention over its context), over the window, as a share of
the H100's dense bf16 peak."""

from benchlib.counts import BF16_FLOPS, decode_flops, prefill_flops


def read(data):
    if not data.get("requests"):
        return None
    a, b, d = data["t_open"], data["t_close"], data["dims"]
    flops = sum(prefill_flops(d, p["s"]) for p in data["prefills"] if a <= p["t"] <= b)
    for r in data["requests"]:
        # token i >= 1 comes from a decode step whose query sits at position
        # prompt + i - 1 and reads prompt + i keys
        flops += sum(decode_flops(d, r["prompt"] + i) for i, s in enumerate(r["stamps"]) if i and a <= s <= b)
    return 100.0 * flops / data["seconds"] / BF16_FLOPS
