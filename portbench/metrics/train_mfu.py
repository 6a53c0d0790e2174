"""Whole step: a step's operations (6 a parameter and token plus attention) at the bf16 peak, over the untraced steps' time, in percent."""
from portbench.readers import train_mfu as read  # noqa: F401
