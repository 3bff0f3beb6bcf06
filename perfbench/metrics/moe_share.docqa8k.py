"""moe_share.docqa8k: the share of the window's prefills (outside the
profiled slice) spent in the program's expert layers: the CUDA-event time of
its ``moe.apply`` spans inside ``serve.prefill`` spans, over those prefills'
own CUDA-event time. Nothing where the program records no such span."""

from benchlib.program_spans import outside


def read(data):
    spans = data.get("spans")
    if not spans:
        return None
    pre = {i for i, s in enumerate(spans) if s.name == "serve.prefill" and s.device_s and outside(data, s)}
    moe = 0.0
    for s in spans:
        if s.name == "moe.apply" and s.device_s is not None:
            p = s.parent
            while p >= 0 and p not in pre:
                p = spans[p].parent
            moe += s.device_s if p >= 0 else 0.0
    if not pre or not moe:
        return None
    return 100.0 * moe / sum(spans[i].device_s for i in pre)
