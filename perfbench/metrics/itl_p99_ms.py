"""itl_p99_ms: the 99th percentile of every gap between consecutive output
tokens of every request that arrived in the window (stamped where each
token reaches the host)."""

from benchlib.stats import gaps, percentile


def read(data):
    if not data.get("requests"):
        return None
    g = [x for r in data["requests"] if r["arrival"] < data["seconds"] for x in gaps(r["stamps"])]
    return 1e3 * percentile(g, 99) if g else None
