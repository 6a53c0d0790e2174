"""adamw kernel: least time of the traced steps' updates over its device time, in percent."""
from portbench.readers import adamw_roofline as read  # noqa: F401
