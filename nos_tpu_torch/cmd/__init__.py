"""Entry-point binaries of the port (``server``, ``generate``,
``trainer``), each run as ``python -m nos_tpu_torch.cmd.<binary>``.

Shared logging lives here, copied from ``nos_tpu/cmd/__init__.py``:
every binary that takes ``--log-format json`` routes through
:func:`setup_logging`, which in json mode emits one JSON object per
line. The reference also injects ``trace_id``/``span_id`` while a
tracing span is active; the port has no tracing yet, so no span is ever
active and its lines are the reference's lines outside a span.
"""
from __future__ import annotations

import json
import logging
import time


class JsonLogFormatter(logging.Formatter):
    """One JSON object per line: time, level, logger, message and, for
    an exception, its traceback."""

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S",
                                time.gmtime(record.created))
            + f".{int(record.msecs):03d}Z",
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, ensure_ascii=False)


def setup_logging(level: int = 0, log_format: str = "text",
                  numeric_level: int = None) -> None:
    """Root logging for a binary. ``log_format`` is ``text`` (the classic
    human-readable line) or ``json`` (one object per line). ``level`` is
    the kube-style -v verbosity (0 = INFO, >0 = DEBUG); binaries whose
    config carries a logging level name pass it via ``numeric_level``,
    which takes precedence."""
    root = logging.getLogger()
    for h in list(root.handlers):
        root.removeHandler(h)
    handler = logging.StreamHandler()
    if log_format == "json":
        handler.setFormatter(JsonLogFormatter())
    else:
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
    root.addHandler(handler)
    if numeric_level is not None:
        root.setLevel(numeric_level)
    else:
        root.setLevel(logging.DEBUG if level > 0 else logging.INFO)
