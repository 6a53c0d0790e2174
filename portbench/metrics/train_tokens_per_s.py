"""Training tokens of every step the window ran, over the window's seconds."""
from portbench.readers import train_tokens_per_s as read  # noqa: F401
