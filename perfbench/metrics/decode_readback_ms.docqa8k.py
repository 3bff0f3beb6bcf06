"""decode_readback_ms.docqa8k: the median of the program's
``serve.decode.readback`` span (the host's wait for a replayed decode
step's tokens: the latent decode and the experts on the card) over the
window's decode steps outside the profiled slice, in ms."""

from benchlib.program_spans import decode_readback_ms as read  # noqa: F401
