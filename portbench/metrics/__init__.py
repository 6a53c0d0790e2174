"""One reader per metric, ``metrics/<name>.py``, each with
``read(run) -> float | None`` (None: nothing to read in this run)."""
