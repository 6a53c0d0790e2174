"""Device: share of the traced step with no operation on the card, in percent."""
from portbench.readers import idle_share as read  # noqa: F401
