"""Structured JSON logging for the serving stack.

The reference's observability is bare `print` calls behind a debug flag
(`modules/utils.py:109-111`) with Triton metrics disabled. This logger
emits one JSON object per line (timestamp, level, event, fields) so the
service's request flow is machine-parseable; /metrics covers aggregates.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from typing import Any, TextIO

_LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40}

# -- Triton logging-extension settings (GET/POST /v2/logging) --
#
# Runtime-adjustable global switches, the exact field set Triton's
# logging extension exposes (tritonclient get_log_settings /
# update_log_settings). The reference deployment's only logging knob is
# a debug print flag (modules/utils.py:109-111); Triton itself serves
# this document. `log_verbose_level > 0` enables debug records (Triton's
# verbose log); log_format "ISO8601" switches the `ts` field from epoch
# seconds to an ISO-8601 string; `log_file` "" logs to stderr, anything
# else appends to that path (all loggers share it, like Triton's single
# log sink).
_SETTINGS_LOCK = threading.Lock()
_settings: dict[str, Any] = {
    "log_info": True,
    "log_warning": True,
    "log_error": True,
    "log_verbose_level": 0,
    "log_format": "default",
    "log_file": "",
}
_log_file_stream: TextIO | None = None


def log_settings() -> dict[str, Any]:
    """Current logging-extension settings (GET /v2/logging document)."""
    with _SETTINGS_LOCK:
        return dict(_settings)


def configure_logging(updates: dict[str, Any]) -> dict[str, Any]:
    """Apply a logging-extension update (POST /v2/logging body) and
    return the full resulting settings. Raises ValueError on unknown
    fields or mistyped values — the extension's 400 contract."""
    global _log_file_stream
    checked: dict[str, Any] = {}
    for key, value in updates.items():
        if key not in _settings:
            raise ValueError(f"unknown log setting '{key}'")
        if key in ("log_info", "log_warning", "log_error"):
            if not isinstance(value, bool):
                raise ValueError(f"'{key}' expects a boolean")
        elif key == "log_verbose_level":
            if not isinstance(value, int) or isinstance(value, bool) \
                    or value < 0:
                raise ValueError("'log_verbose_level' expects an int >= 0")
        elif key == "log_format":
            if value not in ("default", "ISO8601"):
                raise ValueError(
                    "'log_format' expects 'default' or 'ISO8601'"
                )
        elif key == "log_file":
            if not isinstance(value, str):
                raise ValueError("'log_file' expects a string path")
        checked[key] = value
    with _SETTINGS_LOCK:
        old_file = _settings["log_file"]
        new_file = checked.get("log_file", old_file)
        new_stream = None
        if new_file != old_file and new_file:
            # Open BEFORE mutating settings / closing the old stream so an
            # unopenable path maps to the extension's 400 contract and
            # leaves the previous sink intact (advisor r4: OSError here
            # used to escape the route handler after the settings doc
            # already claimed the new file).
            try:
                new_stream = open(  # noqa: SIM115 — held open
                    new_file, "a", encoding="utf-8"
                )
            except OSError as exc:
                raise ValueError(
                    f"cannot open log_file {new_file!r}: {exc}"
                ) from None
        _settings.update(checked)
        if new_file != old_file:
            if _log_file_stream is not None:
                _log_file_stream.close()
            _log_file_stream = new_stream
        return dict(_settings)


def _level_enabled(level: str) -> bool:
    if level == "debug":
        return _settings["log_verbose_level"] > 0
    return bool(_settings.get(f"log_{level}", True))


class JsonLogger:
    def __init__(self, name: str, level: str = "info",
                 stream: TextIO | None = None):
        self.name = name
        self._level = _LEVELS[level]
        # None: the process's stderr at each write (a logger made while
        # sys.stderr was swapped, e.g. by a test's capture, must not keep
        # writing to the old stream)
        self._stream = stream
        self._lock = threading.Lock()

    def _emit(self, level: str, event: str, **fields: Any):
        if _LEVELS[level] < self._level or not _level_enabled(level):
            return
        ts = time.time()
        record = {
            "ts": (time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(ts))
                   + f".{int(ts % 1 * 1e6):06d}Z"
                   if _settings["log_format"] == "ISO8601"
                   else round(ts, 6)),
            "level": level,
            "logger": self.name,
            "event": event,
            **fields,
        }
        line = json.dumps(record, default=str)
        # Snapshot + write under the module lock: a concurrent
        # configure_logging swaps/closes the shared file stream, and all
        # JsonLogger instances share that sink — one lock keeps lines
        # whole and never writes a closed stream (advisor r4). Backstop
        # try/except: logging must never take down a serving thread.
        try:
            with _SETTINGS_LOCK:
                stream = _log_file_stream or self._stream or sys.stderr
                stream.write(line + "\n")
                stream.flush()
        except (OSError, ValueError):
            try:
                sys.stderr.write(line + "\n")
            except OSError:
                pass

    def debug(self, event: str, **fields):
        self._emit("debug", event, **fields)

    def info(self, event: str, **fields):
        self._emit("info", event, **fields)

    def warning(self, event: str, **fields):
        self._emit("warning", event, **fields)

    def error(self, event: str, **fields):
        self._emit("error", event, **fields)


_loggers: dict[str, JsonLogger] = {}


def get_logger(name: str, level: str = "info") -> JsonLogger:
    if name not in _loggers:
        _loggers[name] = JsonLogger(name, level)
    return _loggers[name]
