"""accum_share.train: the share of the window's step time in which the
device ran the trainer's gradient accumulation and combine (the program's
``train.accumulate`` and ``train.combine`` spans, by their CUDA events), in
%."""

from benchlib.program_spans import accum_share as read  # noqa: F401
