"""Structured logging: the port's copy of ``agentfield_tpu/logging.py``,
under its own root logger (``agentfield_torch``), so a process that holds
both packages (the parity tests) does not print a record twice.

Parity with the reference's zerolog-based global logger (internal/logger/):
key-value structured records, JSON or console rendering, level from config or
AGENTFIELD_LOG_LEVEL / AGENTFIELD_LOG_FORMAT env. Stdlib-logging based so
third-party handlers compose.

Usage:
    from agentfield_tpu_torch.logging import get_logger
    log = get_logger("gateway")
    log.info("execution completed", execution_id=eid, duration_ms=12.3)
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Any

_CONFIGURED = False


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        doc = {
            "ts": round(record.created, 3),
            "level": record.levelname.lower(),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        doc.update(getattr(record, "fields", {}))
        if record.exc_info:
            doc["exc"] = self.formatException(record.exc_info)
        return json.dumps(doc, default=str)


class _ConsoleFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        fields = getattr(record, "fields", {})
        kv = " ".join(f"{k}={v}" for k, v in fields.items())
        ts = time.strftime("%H:%M:%S", time.localtime(record.created))
        base = f"{ts} {record.levelname[:4]} [{record.name}] {record.getMessage()}"
        return f"{base} {kv}".rstrip()


class StructuredAdapter(logging.LoggerAdapter):
    """kwargs become structured fields: log.info("msg", key=value). Stdlib
    %-style positional args still interpolate: log.info("x %s", v)."""

    def _log_kv(self, level: int, msg: str, args: tuple, kwargs: dict[str, Any]) -> None:
        exc_info = kwargs.pop("exc_info", None)
        self.logger.log(level, msg, *args, extra={"fields": kwargs}, exc_info=exc_info)

    def debug(self, msg, *args, **kw):  # type: ignore[override]
        self._log_kv(logging.DEBUG, msg, args, kw)

    def info(self, msg, *args, **kw):  # type: ignore[override]
        self._log_kv(logging.INFO, msg, args, kw)

    def warning(self, msg, *args, **kw):  # type: ignore[override]
        self._log_kv(logging.WARNING, msg, args, kw)

    def error(self, msg, *args, **kw):  # type: ignore[override]
        self._log_kv(logging.ERROR, msg, args, kw)

    def exception(self, msg, *args, **kw):  # type: ignore[override]
        self._log_kv(logging.ERROR, msg, args, {"exc_info": True, **kw})


class _DynamicStderrHandler(logging.StreamHandler):
    """Always writes to the CURRENT sys.stderr — survives redirection and
    pytest's per-test capture swapping (a cached stream goes stale)."""

    def emit(self, record):
        self.stream = sys.stderr
        super().emit(record)


def configure(level: str | None = None, fmt: str | None = None) -> None:
    """Root setup. First call (usually implicit via get_logger) applies env
    defaults; later EXPLICIT calls re-apply level/formatter; later implicit
    calls are no-ops — an operator's configure(level="debug", fmt="json")
    sticks regardless of import order."""
    global _CONFIGURED
    root = logging.getLogger("agentfield_torch")
    if not _CONFIGURED:
        eff_level = (level or os.environ.get("AGENTFIELD_LOG_LEVEL", "info")).upper()
        eff_fmt = fmt or os.environ.get("AGENTFIELD_LOG_FORMAT", "console")
        root.setLevel(getattr(logging, eff_level, logging.INFO))
        handler = _DynamicStderrHandler()
        handler.setFormatter(_JsonFormatter() if eff_fmt == "json" else _ConsoleFormatter())
        root.addHandler(handler)
        root.propagate = False
        _CONFIGURED = True
        return
    if level is not None:
        root.setLevel(getattr(logging, level.upper(), logging.INFO))
    if fmt is not None:
        formatter = _JsonFormatter() if fmt == "json" else _ConsoleFormatter()
        for h in root.handlers:
            h.setFormatter(formatter)


def get_logger(name: str) -> StructuredAdapter:
    configure()
    return StructuredAdapter(logging.getLogger(f"agentfield_torch.{name}"), {})
