"""Serving-plane admission refusals (a copy of the two types of
``nos_tpu/models/errors.py`` the port's engine raises).

``Infeasible`` means THIS request can never be served by THIS server
(HTTP 400); ``QueueFull`` means the server is out of capacity right now
(HTTP 429 + Retry-After). ``reason`` is the machine-readable slug the
HTTP layer copies into the body."""


class QueueFull(RuntimeError):
    """Admission refused on TRANSIENT capacity: the pending queue is at
    ``max_pending``. ``reason`` refines the cause on the wire."""

    reason = "queue_full"

    def __init__(self, *args, reason: str = None):
        super().__init__(*args)
        if reason is not None:
            self.reason = reason


class Infeasible(ValueError):
    """Admission refused PERMANENTLY: prompt + max_new_tokens exceeds
    the cache length, or needs more KV blocks than the whole pool."""

    reason = "infeasible"


__all__ = ["QueueFull", "Infeasible"]
