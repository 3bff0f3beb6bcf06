"""decode_issue_ms.docqa: the median of the program's ``serve.decode.issue``
span over the window's decode steps outside the profiled slice (the input
copies and the replay's launch of a captured step), in ms."""

from benchlib.program_spans import decode_issue_ms as read  # noqa: F401
