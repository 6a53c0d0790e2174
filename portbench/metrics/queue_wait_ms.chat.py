"""Admission: mean ms from submit to slot of the requests accounted in the window."""
from portbench.readers import queue_wait_ms as read  # noqa: F401
