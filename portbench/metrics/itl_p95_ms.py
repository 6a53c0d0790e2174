"""95th percentile of the gaps between consecutive output tokens (ms) that end in the window, over all requests."""
from portbench.readers import itl_p95_ms as read  # noqa: F401
