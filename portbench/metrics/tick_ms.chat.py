"""Engine: mean ms of a serving-loop tick in the window (chat)."""
from portbench.readers import tick_ms as read  # noqa: F401
