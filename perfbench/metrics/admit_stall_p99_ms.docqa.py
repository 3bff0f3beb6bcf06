"""admit_stall_p99_ms.docqa: the 99th percentile, over the window's ticks
outside the profiled slice in which a slot was decoding, of the tick's time
inside the program's ``serve.admit`` spans (a prefill and its first token
hold every decoding slot), in ms."""

from benchlib.program_spans import admit_stall_p99_ms as read  # noqa: F401
