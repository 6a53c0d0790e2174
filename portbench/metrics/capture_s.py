"""Engine set-up: seconds the decode programs' graph captures took."""
from portbench.readers import capture_s as read  # noqa: F401
