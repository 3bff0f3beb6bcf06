"""train_tok_s: the tokens of every global step completed inside the
window, over the time from the first of them starting to the last ending."""


def read(data):
    steps = data.get("steps") or []
    if not steps:
        return None
    return sum(s["tokens"] for s in steps) / (steps[-1]["t1"] - steps[0]["t0"])
