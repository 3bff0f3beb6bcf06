"""decode_step_ms.batch: the window over the decode steps taken in it (one
step advances every occupied slot; the prefills of new requests between
steps are inside the window too)."""


def read(data):
    if "stats_open" not in data:
        return None
    calls = data["stats_close"]["decode_calls"] - data["stats_open"]["decode_calls"]
    return 1e3 * data["seconds"] / calls if calls > 0 else None
