"""95th percentile of time to first token (ms), from each request's due time, over the requests due in the window."""
from portbench.readers import ttft_p95_ms as read  # noqa: F401
