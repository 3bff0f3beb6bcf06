"""decode_graph_share.batch: the share of the window's decode calls that
replayed the program's captured decode step, from the serving loop's own
counts (``stats()``'s ``decode_graph_replays`` and ``decode_calls``, taken
at the window's opening and close). Nothing where the program keeps no such
count."""


def read(data):
    if "stats_open" not in data:
        return None
    a, b = data["stats_open"], data["stats_close"]
    if "decode_graph_replays" not in b:
        return None
    calls = b["decode_calls"] - a["decode_calls"]
    if calls <= 0:
        return None
    return 100.0 * (b["decode_graph_replays"] - a["decode_graph_replays"]) / calls
