"""glog-analog logging for tpumon (reference: pod exporter's glog use,
``pod-gpu-metrics-exporter/src/main.go:18-33`` — ``-logtostderr`` +
``-v`` levels).

Three things the stdlib doesn't give directly, packaged here:

* **V-levels**: ``vlog(2, ...)`` emits only when verbosity >= 2.
  Verbosity comes from ``set_verbosity()`` (CLI ``--v`` flags) or the
  ``TPUMON_VERBOSITY`` env var, so DaemonSet operators can turn a node
  chatty without redeploying binaries.
* **glog line format** on stderr: ``W0730 05:43:12.123456 pid file:line]
  msg`` — one-letter severity, compact timestamp, source location.
* **Rate-limited warnings**: ``warn_every(key, interval_s, ...)`` for
  per-sweep failure paths.  A persistently failing backend at a 10 ms
  sweep floor must be *visible* (swallowed
  exceptions made it invisible except via /healthz) but must not emit
  100 lines/s; one line per interval per key, with a suppressed-count
  suffix, is the glog ``LOG_EVERY_N`` idiom.

Everything goes through a stdlib ``logging.Logger`` named ``tpumon``, so
embedding applications can attach their own handlers/filters; the stderr
glog handler is only installed when nobody else configured one.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time
from typing import Any, Dict, Tuple

_logger = logging.getLogger("tpumon")


def _env_verbosity() -> int:
    # a typo in a logging knob must not take the exporter down at import
    try:
        return int(os.environ.get("TPUMON_VERBOSITY", "0") or "0")
    except ValueError:
        return 0


_verbosity = _env_verbosity()
_lock = threading.Lock()
#: key -> (last emit monotonic, suppressed count)
_rate: Dict[str, Tuple[float, int]] = {}

_SEVERITY_LETTER = {logging.DEBUG: "V", logging.INFO: "I",
                    logging.WARNING: "W", logging.ERROR: "E",
                    logging.CRITICAL: "F"}


class _GlogFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        t = time.localtime(record.created)
        usec = int((record.created % 1) * 1e6)
        letter = _SEVERITY_LETTER.get(record.levelno, "I")
        return (f"{letter}{t.tm_mon:02d}{t.tm_mday:02d} "
                f"{t.tm_hour:02d}:{t.tm_min:02d}:{t.tm_sec:02d}.{usec:06d} "
                f"{record.process} {record.filename}:{record.lineno}] "
                f"{record.getMessage()}")


class _StderrHandler(logging.Handler):
    """Writes to the CURRENT sys.stderr (not the one at install time), so
    stream redirection — test capture, daemonization re-exec — works."""

    def emit(self, record: logging.LogRecord) -> None:
        try:
            sys.stderr.write(self.format(record) + "\n")
        except Exception:  # stderr gone: logging must never raise
            pass


def _ensure_handler() -> None:
    # glog semantics: stderr, always — unless the embedding app configured
    # the "tpumon" logger itself (then its handlers own the stream).
    # Locked: two sweep threads hitting this concurrently must not both
    # install a handler (every line would emit twice forever).
    with _lock:
        if _logger.handlers:
            return
        h = _StderrHandler()
        h.setFormatter(_GlogFormatter())
        _logger.addHandler(h)
        _logger.setLevel(logging.DEBUG)
        _logger.propagate = False


def set_verbosity(v: int) -> None:
    global _verbosity
    _verbosity = int(v)


def verbosity() -> int:
    return _verbosity


def V(level: int) -> bool:
    """glog ``VLOG_IS_ON`` — true when verbose logs at ``level`` emit."""

    return _verbosity >= level


# stacklevel=2: report the caller of info()/warning()/..., not this module
def vlog(level: int, msg: str, *args: Any) -> None:
    if _verbosity >= level:
        _ensure_handler()
        _logger.debug(msg, *args, stacklevel=2)


def info(msg: str, *args: Any) -> None:
    _ensure_handler()
    _logger.info(msg, *args, stacklevel=2)


def warning(msg: str, *args: Any) -> None:
    _ensure_handler()
    _logger.warning(msg, *args, stacklevel=2)


def error(msg: str, *args: Any) -> None:
    _ensure_handler()
    _logger.error(msg, *args, stacklevel=2)


def warn_every(key: str, interval_s: float, msg: str, *args: Any) -> bool:
    """Emit a WARNING at most once per ``interval_s`` per ``key``.

    Returns True when the line was emitted.  Suppressed occurrences are
    counted and reported on the next emitted line, so operators can see
    failure *rate*, not just presence.
    """

    now = time.monotonic()
    with _lock:
        last, suppressed = _rate.get(key, (-1e18, 0))
        if now - last < interval_s:
            _rate[key] = (last, suppressed + 1)
            return False
        _rate[key] = (now, 0)
    _ensure_handler()
    suffix = f" [{suppressed} similar suppressed]" if suppressed else ""
    _logger.warning(msg + suffix, *args, stacklevel=2)
    return True


def reset_rate_limits() -> None:
    """Test helper: forget rate-limit state."""

    with _lock:
        _rate.clear()
