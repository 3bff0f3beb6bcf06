"""queue_wait_p90_ms.docqa: the 90th percentile over every request that
arrived in the window of the wait from its scheduled arrival until the
serving loop granted it a slot (``Request.submitted``), when its prefill
starts. A request never admitted counts at the run's end."""

from benchlib.stats import percentile


def read(data):
    if not data.get("requests"):
        return None
    t = [(x["submitted"] if x["first_token"] >= 0 else data["t_end"]) - x["arrival"]
         for x in data["requests"] if x["arrival"] < data["seconds"]]
    return 1e3 * percentile(t, 90)
