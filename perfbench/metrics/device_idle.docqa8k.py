"""device_idle.docqa8k: the share of the profiled slice in which no kernel,
copy or fill ran on the device (1 - busy / slice, from ``torch.profiler``'s
device timeline)."""

from benchlib.trace import idle_share as read  # noqa: F401
