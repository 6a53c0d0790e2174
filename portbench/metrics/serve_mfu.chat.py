"""Whole step: the window's least time at the card's peaks over the window, in percent (chat)."""
from portbench.readers import serve_mfu as read  # noqa: F401
