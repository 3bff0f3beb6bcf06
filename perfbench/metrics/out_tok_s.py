"""out_tok_s: every output token emitted inside the window, over the
window."""


def read(data):
    if not data.get("requests"):
        return None
    a, b = data["t_open"], data["t_close"]
    n = sum(1 for r in data["requests"] for s in r["stamps"] if a <= s <= b)
    return n / data["seconds"]
