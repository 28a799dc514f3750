"""Shared CLI plumbing: connection flags, ticker loops, formatting.

The port's copy of ``tpumon/cli/common.py``.  Every sample accepts the
same connection flags, mapping the reference's pattern of a ``-connect
address`` flag on dcgm samples (``samples/dcgm/deviceInfo/main.go:36-39``)
plus run-mode selection:

    --backend nvml|cuda|fake|auto  embedded-mode source (or TPUMON_BACKEND)
    --connect ADDR                 standalone mode: unix:/path or host:port
    --start-agent                  start a local agent (the native
                                   gpu-hostengine) and connect

The 1 s ticker loop shape (signal-aware, immediate first tick) follows
``samples/dcgm/dmon/main.go:39-59``.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading
from typing import Callable, Iterator, Optional

import tpumon_torch
from .. import log

def add_connection_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--backend", default=None,
                   help="embedded backend: nvml|cuda|fake|auto "
                        "(default: $TPUMON_BACKEND or auto, the NVML "
                        "source)")
    p.add_argument("--connect", default=None, metavar="ADDR",
                   help="connect to a running agent (unix:/path or "
                        "host:port)")
    p.add_argument("--start-agent", action="store_true",
                   help="start a local agent and connect to it")
    p.add_argument("--v", type=int, default=None, metavar="N",
                   help="log verbosity level (glog-style; default "
                        "$TPUMON_VERBOSITY or 0)")


def init_from_args(args: argparse.Namespace) -> "tpumon_torch.Handle":
    """Initialize the refcounted handle per the connection flags."""

    if getattr(args, "v", None) is not None:
        log.set_verbosity(args.v)
    if getattr(args, "connect", None):
        return tpumon_torch.init(tpumon_torch.RunMode.STANDALONE,
                                 address=args.connect)
    if getattr(args, "start_agent", False):
        return tpumon_torch.init(tpumon_torch.RunMode.START_AGENT)
    return tpumon_torch.init(backend_name=getattr(args, "backend", None))


def die(msg: str, rc: int = 1) -> "NoReturn":  # noqa: F821
    print(f"error: {msg}", file=sys.stderr)
    sys.exit(rc)


def epipe_safe(fn: Callable[[], int]) -> int:
    """Run a streaming CLI body; exit quietly when the consumer closes the
    pipe (``tpumon-dmon | head`` must not traceback)."""

    try:
        return fn()
    except BrokenPipeError:
        # reopen stdout on devnull so the interpreter's exit flush is silent
        try:
            os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        except OSError:
            pass
        return 0


def ticker(interval_s: float, count: Optional[int] = None) -> Iterator[int]:
    """Signal-aware ticker: yields tick number, first tick immediately.

    Stops on SIGINT/SIGTERM or after ``count`` ticks (None = forever).
    """

    stop = threading.Event()

    def _sig(_signum: int, _frame: object) -> None:
        stop.set()

    old_int = signal.signal(signal.SIGINT, _sig)
    old_term = signal.signal(signal.SIGTERM, _sig)
    try:
        i = 0
        while not stop.is_set():
            yield i
            i += 1
            if count is not None and i >= count:
                break
            if stop.wait(interval_s):
                break
    finally:
        signal.signal(signal.SIGINT, old_int)
        signal.signal(signal.SIGTERM, old_term)


def fmt(value, width: int = 0, dash: str = "-") -> str:
    """Blank-tolerant formatter: None -> '-', floats to 1 decimal."""

    if value is None:
        s = dash
    elif isinstance(value, float):
        s = f"{value:.1f}"
    else:
        s = str(value)
    return s.rjust(width) if width else s
