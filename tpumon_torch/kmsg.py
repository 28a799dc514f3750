"""Kernel-log event source: Xid and PCIe errors of NVIDIA GPUs.

The port's copy of ``tpumon/kmsg.py``.  The NVIDIA driver reports a GPU
fault to the kernel log as an Xid line,

    NVRM: Xid (PCI:0000:3b:00): 79, pid=..., GPU has fallen off the bus.

and this module tails a kmsg-format stream and turns such lines, and AER
lines about an NVIDIA GPU's PCI bus id, into :class:`tpumon_torch.events.Event`
records.  It is the second event source of the NVML backend
(:mod:`tpumon_torch.backends.nvml`) beside NVML's own event set, and the
only one where the event set cannot be registered (a VM that refuses it).

The watcher is the reference's, unchanged: ``/dev/kmsg`` records
``"<prio>,<seq>,<usec>,<flags>;<message>"``, continuation lines ignored,
the reader starts at EOF, ``EPIPE`` (overtaken by the ring buffer)
re-seeks, and ``TPUMON_KMSG_PATH`` replaces ``/dev/kmsg`` (the hermetic
tests' hook and an operator's escape hatch).

Only the classifier differs.  The reference gates lines on TPU words and
matches phrasing; here an Xid line is classified by its code alone, and
only the codes that NVIDIA's published Xid catalog ("Xid Errors", NVIDIA
GPU deployment and management documentation) gives a clear meaning are
mapped.  An unknown code gives None, never a guess.  The reference's
THERMAL and RUNTIME_RESTART have no Xid: the catalog reports neither a
slowdown nor a runtime's restart as one.
"""

from __future__ import annotations

import errno
import os
import re
import threading
import time
from typing import Callable, Mapping, Optional, Tuple

from . import log
from .events import EventType

#: Xid code -> event type, from NVIDIA's Xid catalog:
#: 48 "DBE (Double Bit Error) ECC Error"; 63 "ECC page retirement or row
#: remapping recording event"; 64 "ECC page retirement or row remapper
#: recording failure"; 74 "NVLink Error"; 79 "GPU has fallen off the bus";
#: 92 "High single-bit ECC error rate".
XID_EVENTS: Mapping[int, EventType] = {
    48: EventType.ECC_DBE,
    63: EventType.HBM_REMAP,
    64: EventType.HBM_REMAP,
    74: EventType.ICI_ERROR,
    79: EventType.CHIP_RESET,
    92: EventType.ECC_SBE_STORM,
}

#: (PCI domain, bus, device) of a GPU: the key both a kmsg line's bus id
#: and NVML's ``busId`` reduce to (the driver's Xid lines drop the
#: function and print a 4-digit domain; NVML prints 8 digits)
BusKey = Tuple[int, int, int]

_XID_RE = re.compile(
    r"NVRM: Xid \(PCI:([0-9a-fA-F]+:[0-9a-fA-F]+:[0-9a-fA-F]+)[^)]*\): "
    r"(\d+)")
#: the reference's PCIe pattern
_PCIE_RE = re.compile(r"AER|PCIe.{0,24}(error|replay|timeout)", re.I)
_BUS_RE = re.compile(
    r"\b([0-9a-fA-F]{4,8}):([0-9a-fA-F]{2}):([0-9a-fA-F]{2})(?:\.[0-7])?\b")
#: the NVIDIA driver's own device prefix (``nvidia 0000:3b:00.0: ...``)
_NVIDIA_DEV_RE = re.compile(
    r"\bnvidia ([0-9a-fA-F]{4,8}:[0-9a-fA-F]{2}:[0-9a-fA-F]{2})")


def bus_key(bus_id: str) -> Optional[BusKey]:
    """The (domain, bus, device) of a PCI bus id such as ``0000:3b:00``,
    ``0000:3b:00.0`` or NVML's ``00000000:3B:00.0``; None if it is none."""

    m = _BUS_RE.search(bus_id)
    if m is None:
        return None
    return int(m.group(1), 16), int(m.group(2), 16), int(m.group(3), 16)


def is_xid_line(message: str) -> bool:
    return _XID_RE.search(message) is not None


def classify_line(message: str,
                  buses: Optional[Mapping[BusKey, int]] = None,
                  ) -> Optional[Tuple[EventType, int]]:
    """(event type, GPU index | -1) for an Xid line of a mapped code, or
    an AER/PCIe error line about an NVIDIA GPU; else None.  ``buses``
    maps a GPU's bus key to the index its backend serves; a bus id it
    does not hold gives -1.  Pure function — the unit under test."""

    buses = buses or {}
    m = _XID_RE.search(message)
    if m is not None:
        etype = XID_EVENTS.get(int(m.group(2)))
        if etype is None:
            return None
        return etype, buses.get(bus_key(m.group(1)), -1)
    if not _PCIE_RE.search(message):
        return None
    for bm in _BUS_RE.finditer(message):
        key = bus_key(bm.group(0))
        if key in buses:
            return EventType.PCIE_ERROR, buses[key]
    if _NVIDIA_DEV_RE.search(message):
        return EventType.PCIE_ERROR, -1
    return None


def parse_kmsg_record(line: str) -> Optional[str]:
    """Extract the message text from one kmsg record; None for
    continuation/garbage lines."""

    if not line or line[0] == " ":
        return None  # continuation (key=value) line
    _, sep, message = line.partition(";")
    if not sep:
        return None
    return message.rstrip("\n")


class KmsgWatcher:
    """Tails a kmsg stream and delivers classified events to a sink.

    ``sink(chip_index, event_type, timestamp, message)`` — the same shape
    as the shim's vendor-event callback, so backends reuse one ingestion
    path.  Start/stop are idempotent; the reader thread survives EPIPE
    (ring overrun) and transient open failures.
    """

    def __init__(self, sink: Callable[[int, int, float, str], None],
                 path: Optional[str] = None,
                 poll_interval_s: float = 0.2,
                 from_start: bool = False,
                 buses: Optional[Mapping[BusKey, int]] = None) -> None:
        self._sink = sink
        self._buses = buses
        self._path = path or os.environ.get("TPUMON_KMSG_PATH", "/dev/kmsg")
        self._poll = poll_interval_s
        self._from_start = from_start
        self._stop = threading.Event()
        self._ready = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def path(self) -> str:
        return self._path

    def available(self) -> bool:
        try:
            fd = os.open(self._path, os.O_RDONLY | os.O_NONBLOCK)
        except OSError:
            return False
        os.close(fd)
        return True

    def start(self, wait_ready_s: float = 2.0) -> bool:
        th = self._thread
        if th is not None:
            if th.is_alive() and not self._stop.is_set():
                return True
            if th is threading.current_thread():
                return True  # a sink cannot restart the watcher it runs on
            # stopped (or sink-stopped, still draining) tailer: reap it
            # BEFORE clearing the stop event, so a restart can never
            # revive the old thread into a duplicate delivery stream
            th.join(timeout=5.0)
            if th.is_alive():
                # wedged drain: the stop event stays set (it WILL exit)
                # and no fresh tailer can safely start — report
                # not-running so callers can unwire/fall back
                return False
            if self._thread is th:
                self._thread = None
        if not self.available():
            return False
        self._stop.clear()
        self._ready.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="tpumon-kmsg")
        self._thread.start()
        # wait for the initial open+seek: records appended after start()
        # returns are then guaranteed visible (not raced past by the
        # skip-history seek)
        self._ready.wait(wait_ready_s)
        return True

    def stop(self) -> None:
        """Signal the tailer and join it (bounded), so interpreter
        teardown can never race a mid-delivery thread.  Idempotent,
        and safe to call from the sink itself: a thread cannot join
        itself, so a sink-triggered stop only signals — the handle
        stays set so a later off-thread stop() can still join, and
        start() reaps the exiting tailer instead of reviving it."""

        self._stop.set()
        th = self._thread
        if th is None or th is threading.current_thread():
            return
        th.join(timeout=5.0)
        if self._thread is th and not th.is_alive():
            # only clear the handle we actually reaped — a concurrent
            # start() may have swapped in a fresh tailer already
            self._thread = None

    # -- reader ---------------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                fd = os.open(self._path, os.O_RDONLY | os.O_NONBLOCK)
            except OSError as e:
                log.warn_every("kmsg.open", 60.0,
                               "cannot open %s: %r", self._path, e)
                if self._stop.wait(1.0):
                    return
                continue
            try:
                if not self._from_start:
                    # every open (first AND re-open after a read error):
                    # start at the end.  Replaying history would duplicate
                    # already-delivered events and stamp boot-time records
                    # with the current time; messages that raced the gap
                    # are lost instead, which is the lesser evil and what
                    # the overrun path already accepts.
                    try:
                        os.lseek(fd, 0, os.SEEK_END)
                    except OSError:
                        pass  # stream without seek: read from the top
                self._ready.set()
                self._pump(fd)
            finally:
                os.close(fd)
            if self._stop.wait(self._poll):
                return

    def _pump(self, fd: int) -> None:
        """Drain records until EOF/EAGAIN; returns to let the caller re-open
        after ring overrun or rotation."""

        buf = b""
        while not self._stop.is_set():
            try:
                chunk = os.read(fd, 8192)
            except OSError as e:
                if e.errno == errno.EPIPE:
                    # overtaken by the ring buffer: records were lost;
                    # continue from the (new) next record
                    log.warn_every("kmsg.overrun", 60.0,
                                   "kmsg ring overrun; some kernel "
                                   "messages were missed")
                    continue
                if e.errno == errno.EAGAIN:
                    if self._stop.wait(self._poll):
                        return
                    continue
                # any other read error (EINVAL oversized record, EIO,
                # device went away): log and RETURN so _run re-opens —
                # raising here would silently kill the watcher thread
                log.warn_every("kmsg.read", 60.0,
                               "kmsg read failed (%s); re-opening", e)
                return
            if not chunk:  # EOF (fixture file) — poll for appends
                if self._stop.wait(self._poll):
                    return
                continue
            buf += chunk
            while b"\n" in buf:
                raw, _, buf = buf.partition(b"\n")
                self._handle(raw.decode("utf-8", "replace"))

    def _handle(self, line: str) -> None:
        message = parse_kmsg_record(line)
        if message is None:
            return
        hit = classify_line(message, self._buses)
        if hit is None:
            return
        etype, chip = hit
        log.vlog(1, "kmsg event: type=%s chip=%d %r", etype.name, chip,
                 message[:120])
        try:
            # wall clock on purpose: event timestamps are the exported
            # cross-host correlation key, not an interval measurement
            self._sink(chip, int(etype), time.time(),  # tpumon-lint: disable=wallclock-in-sampling
                       message)
        except Exception as e:  # a broken sink must not kill the tailer
            log.warn_every("kmsg.sink", 60.0, "event sink failed: %r", e)
