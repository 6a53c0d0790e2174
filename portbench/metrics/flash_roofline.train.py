"""Flash attention kernels: least time of their traced launches over their device time, in percent."""
from portbench.readers import flash_roofline as read  # noqa: F401
