"""Paged decode kernel: least time of its calls in the traced slice over their device time, in percent (chat)."""
from portbench.readers import paged_attn_roofline as read  # noqa: F401
