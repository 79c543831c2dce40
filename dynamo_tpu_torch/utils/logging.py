"""Structured logging for the port (a copy of the JAX package's
`utils/logging.py`, without the instance label, which comes with M17).

Mirrors the reference's tracing init (reference: lib/runtime/src/logging.rs:62-130):
env-var level filter (``DYN_LOG``, e.g. ``debug`` or ``info,dynamo_tpu_torch.http=debug``),
optional JSONL output (``DYN_LOGGING_JSONL=1``) for log aggregation.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time

from dynamo_tpu_torch.utils import tracing

_CONFIGURED = False

_LEVELS = {
    "trace": 5,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}

logging.addLevelName(5, "TRACE")


class JsonlFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(record.created)),
            "level": record.levelname,
            "target": record.name,
            "message": record.getMessage(),
        }
        # join key against the trace plane: the active request id (bound
        # by the HTTP frontend for the handler's task tree, see
        # utils/tracing.py) stamps every record emitted serving that
        # request, so JSONL logs line up with /debug/trace spans
        rid = tracing.current_request()
        if rid is not None:
            out["request_id"] = rid
        if record.exc_info:
            out["exception"] = self.formatException(record.exc_info)
        return json.dumps(out)


def configure_logging(level: str | None = None) -> None:
    """Initialise root logging from env. Idempotent."""
    global _CONFIGURED
    if _CONFIGURED:
        return
    _CONFIGURED = True

    spec = level or os.environ.get("DYN_LOG", "info")
    # spec grammar: "<default>[,<logger>=<level>]*"
    parts = [p.strip() for p in spec.split(",") if p.strip()]
    default = "info"
    per_logger: dict[str, str] = {}
    for p in parts:
        if "=" in p:
            name, lvl = p.split("=", 1)
            per_logger[name] = lvl
        else:
            default = p

    handler = logging.StreamHandler(sys.stderr)
    if os.environ.get("DYN_LOGGING_JSONL"):
        handler.setFormatter(JsonlFormatter())
    else:
        handler.setFormatter(
            logging.Formatter(
                "%(asctime)s %(levelname)-5s %(name)s: %(message)s",
                datefmt="%H:%M:%S",
            )
        )
    root = logging.getLogger()
    root.handlers[:] = [handler]
    root.setLevel(_LEVELS.get(default.lower(), logging.INFO))
    for name, lvl in per_logger.items():
        logging.getLogger(name).setLevel(_LEVELS.get(lvl.lower(), logging.INFO))


def get_logger(name: str) -> logging.Logger:
    configure_logging()
    return logging.getLogger(name)
