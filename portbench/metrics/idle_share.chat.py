"""Device: share of the traced slice with no operation on the card, in percent (chat)."""
from portbench.readers import idle_share as read  # noqa: F401
