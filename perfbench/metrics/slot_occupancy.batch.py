"""slot_occupancy.batch: the share of the arena's slots that decoded in the
window's decode steps, from the serving loop's own counts (``stats()``'s
``slot_occupancy`` and ``decode_calls``, taken at the window's opening and
close)."""


def read(data):
    if "stats_open" not in data:
        return None
    a, b, n = data["stats_open"], data["stats_close"], data["slots"]
    calls = b["decode_calls"] - a["decode_calls"]
    if calls <= 0:
        return None
    occupied = b["slot_occupancy"] * b["decode_calls"] * n - a["slot_occupancy"] * a["decode_calls"] * n
    return 100.0 * occupied / (calls * n)
