"""Logging configuration: GUBER_LOG_LEVEL / GUBER_LOG_FORMAT.

The port's copy of gubernator_tpu/utils/logging_setup.py, which
`cmd/daemon.py` calls.

reference: config.go:255-280 — the reference switches logrus level and
text/json formatting from these variables; here the stdlib logging
layer gets the same surface (json lines carry time/level/logger/msg,
matching the reference's machine-readable intent).
"""

from __future__ import annotations

import json
import logging
import os


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "time": self.formatTime(record, "%Y-%m-%dT%H:%M:%S%z"),
            "level": record.levelname.lower(),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        # Structured logs join the trace that emitted them: a log line
        # inside an active span carries its trace_id, so the flight
        # recorder's tail trees and the logs correlate on one id
        # (utils/tracing.current_trace_id; '' when tracing is off —
        # one global check).
        from gubernator_tpu_torch.utils.tracing import current_trace_id

        trace_id = current_trace_id()
        if trace_id:
            out["trace_id"] = trace_id
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out)


def configure_logging(debug: bool = False) -> None:
    """Apply GUBER_LOG_LEVEL (trace/debug/info/warn/error; -debug flag
    wins) and GUBER_LOG_FORMAT (text|json)."""
    level_name = os.environ.get("GUBER_LOG_LEVEL", "").lower()
    level = {
        "trace": logging.DEBUG,
        "debug": logging.DEBUG,
        "info": logging.INFO,
        "warn": logging.WARNING,
        "warning": logging.WARNING,
        "error": logging.ERROR,
    }.get(level_name, logging.INFO)
    if debug:
        level = logging.DEBUG
    handler = logging.StreamHandler()
    if os.environ.get("GUBER_LOG_FORMAT", "text").lower() == "json":
        handler.setFormatter(JsonFormatter())
    else:
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s %(message)s")
        )
    root = logging.getLogger()
    root.handlers[:] = [handler]
    root.setLevel(level)
