"""Serving loop: host ms a tick outside the device wait, over the window (chat)."""
from portbench.readers import loop_host_ms as read  # noqa: F401
