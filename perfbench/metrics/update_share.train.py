"""update_share.train: the share of the window's step time inside the
optimizer update (the ``update_fn`` the coordinator calls, AdamW in place),
timed on the device by CUDA events around it: from the end of the step's
last gradient work to the end of the update's."""


def read(data):
    steps = data.get("steps") or []
    if not steps:
        return None
    return 100.0 * sum(s["update_s"] for s in steps) / (steps[-1]["t1"] - steps[0]["t0"])
