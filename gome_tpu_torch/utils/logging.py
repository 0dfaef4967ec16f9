"""Logging (the port's copy of ``gome_tpu/utils/logging.py``) — the
reference's util/logger.go:9-23 re-expressed on stdlib logging:
`Info`/`Error` writers multi-targeting order.log + stderr, plus
structured extras the reference lacks (level filtering, per-module names,
and an optional JSON-lines mode that stamps every record with the current
order trace id so log lines join against flight-recorder spans).
"""

from __future__ import annotations

import json
import logging
import os
import sys

_CONFIGURED = False
LOG_FILE = "order.log"  # logger.go:14 — same default file name

#: Env switch for the JSON-lines formatter (configure(json_lines=None)
#: reads it): any of 1/true/yes/on enables.
JSON_ENV = "GOME_LOG_JSON"

#: Env override for WHERE order.log lands (configure(log_dir=None) reads
#: it). The reference drops the file in the CWD; that kept re-littering
#: this repo's root whenever a test or script booted a service from it.
DIR_ENV = "GOME_LOG_DIR"


def _default_log_dir() -> str:
    """Directory for the log file when the caller names none: the
    GOME_LOG_DIR env override first; under pytest, the system tmp dir;
    when the CWD is a source checkout (a `.git` or `pyproject.toml`
    marker), the system tmp dir again — the pytest guard alone kept
    missing scripts/ entry points run from the repo root, and every such
    run re-littered the checkout with a stray order.log; otherwise the
    CWD (empty string — reference behavior, logger.go:14)."""
    d = os.environ.get(DIR_ENV)
    if d:
        return d
    if "PYTEST_CURRENT_TEST" in os.environ or "pytest" in sys.modules:
        import tempfile

        return tempfile.gettempdir()
    if os.path.exists(".git") or os.path.exists("pyproject.toml"):
        import tempfile

        return tempfile.gettempdir()
    return ""


class JsonLineFormatter(logging.Formatter):
    """One JSON object per line: ts (unix seconds), level, logger, msg —
    plus trace_id when the record was emitted inside a traced request
    (utils.trace.current_trace_id, bound by the gateway handlers), so a
    grep for a trace id surfaces both its spans and its log lines."""

    def format(self, record: logging.LogRecord) -> str:
        from .trace import current_trace_id

        d = {
            "ts": round(record.created, 6),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        tid = current_trace_id()
        if tid is not None:
            d["trace_id"] = tid
        if record.exc_info:
            d["exc"] = self.formatException(record.exc_info)
        return json.dumps(d, separators=(",", ":"), default=str)


def _json_enabled(json_lines: bool | None) -> bool:
    if json_lines is not None:
        return json_lines
    return os.environ.get(JSON_ENV, "").lower() in ("1", "true", "yes", "on")


def configure(
    log_file: str | None = LOG_FILE,
    level: int = logging.INFO,
    json_lines: bool | None = None,
    log_dir: str | None = None,
) -> None:
    """Idempotent root setup: file + stderr handlers (logger.go:17-22's
    io.MultiWriter). Call once at process start; get_logger works either
    way (falls back to stderr-only if never configured). json_lines
    selects the JSON-lines formatter (None: the GOME_LOG_JSON env var
    decides) — each record then carries the current trace id. log_dir
    places the file (None: GOME_LOG_DIR env, then tmp under pytest,
    then CWD — _default_log_dir); the directory is created if needed."""
    global _CONFIGURED
    if _CONFIGURED:
        return
    root = logging.getLogger("gome_tpu_torch")
    root.setLevel(level)
    if _json_enabled(json_lines):
        fmt: logging.Formatter = JsonLineFormatter()
    else:
        fmt = logging.Formatter(
            "%(asctime)s [%(levelname)s] %(name)s: %(message)s"
        )
    stderr = logging.StreamHandler(sys.stderr)
    stderr.setFormatter(fmt)
    root.addHandler(stderr)
    if log_file:
        d = log_dir if log_dir is not None else _default_log_dir()
        path = log_file
        if d:
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, log_file)
        fh = logging.FileHandler(path)
        fh.setFormatter(fmt)
        root.addHandler(fh)
    _CONFIGURED = True


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(f"gome_tpu_torch.{name}")
