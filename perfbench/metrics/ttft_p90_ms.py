"""ttft_p90_ms: the 90th percentile of time to first token over every
request that arrived in the window, each timed from its scheduled arrival.
A request that never finished counts as missing: its time is at least the
run's end less its arrival, and that lower bound stands in for it."""

from benchlib.stats import percentile


def read(data):
    if not data.get("requests"):
        return None
    t = [(x["first_token"] if x["finished"] >= 0 else data["t_end"]) - x["arrival"]
         for x in data["requests"] if x["arrival"] < data["seconds"]]
    return 1e3 * percentile(t, 90)
