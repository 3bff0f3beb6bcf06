"""decode_readback_ms.batch: the median of the program's
``serve.decode.readback`` span (the host's wait for a decode step's tokens)
over the window's decode steps outside the profiled slice, in ms."""

from benchlib.program_spans import decode_readback_ms as read  # noqa: F401
