"""Backend interface: the seam between the public API and a metrics source.

A copy of the JAX package's interface, so the watch layer and the exporter
run unchanged against the port's sources.  Slice 1 has one:
:class:`tpumon_torch.backends.cuda.CudaBackend`, in-process CUDA telemetry
for a monitor embedded in the workload process itself.

Every dynamic read returns ``None`` for unsupported fields (NVML
nil-on-NOT_SUPPORTED convention, reference ``bindings/go/nvml/bindings.go:222-224``).
"""

from __future__ import annotations

import abc
import math
import time
from typing import Dict, List, Optional, Tuple, Union

from ..events import Event
from ..types import ChipInfo, DeviceProcess, TopologyInfo, VersionInfo

#: scalar value, or a list for vector fields (one element per link etc.;
#: see FieldMeta.vector_label) — list elements may themselves be None
FieldValue = Union[int, float, str, None, List[Union[int, float, None]]]


def scalar_int(v: FieldValue) -> Optional[int]:
    """Narrow a FieldValue to an int, blank-on-mismatch: the nil
    convention must survive a backend bug that returns a vector/string
    for a scalar field (consumers degrade to blank, never crash).  The
    one narrowing helper for every numeric consumer (device status,
    health checks, policy thresholds)."""

    if not isinstance(v, (int, float)):
        return None
    if isinstance(v, float) and not math.isfinite(v):
        return None  # NaN/inf off a wire decode: blank, don't raise
    return int(v)


def scalar_float(v: FieldValue) -> Optional[float]:
    if not isinstance(v, (int, float)):
        return None
    f = float(v)
    # same non-finite filter as scalar_int: a NaN power reading must
    # read blank, not poison threshold comparisons (nan > limit is
    # always False — the health check would silently never fire)
    return f if math.isfinite(f) else None


class BackendError(Exception):
    """Base error for backend failures."""


class LibraryNotFound(BackendError):
    """The native TPU library/agent is absent on this host.

    Analog of ``NVML_ERROR_LIBRARY_NOT_FOUND`` (``nvml_dl.c:21-28``): callers
    use this to degrade gracefully on CPU-only machines.
    """


class ChipNotFound(BackendError):
    """Chip index out of range or chip lost."""


class Backend(abc.ABC):
    """A source of TPU chip inventory, metrics and events."""

    #: short identifier ("fake", "libtpu", "pjrt", "agent")
    name: str = "abstract"

    # -- lifecycle ------------------------------------------------------------

    @abc.abstractmethod
    def open(self) -> None:
        """Initialize the source. Raises LibraryNotFound on CPU-only hosts."""

    @abc.abstractmethod
    def close(self) -> None:
        """Release the source. Idempotent."""

    # -- inventory ------------------------------------------------------------

    @abc.abstractmethod
    def chip_count(self) -> int:
        """Number of chips visible on this host (GetAllDeviceCount analog)."""

    def supported_chips(self) -> List[int]:
        """Indices usable for monitoring (GetSupportedDevices analog)."""

        return list(range(self.chip_count()))

    @abc.abstractmethod
    def chip_info(self, index: int) -> ChipInfo:
        """Static info for one chip (NewDevice analog). Raises ChipNotFound."""

    @abc.abstractmethod
    def versions(self) -> VersionInfo:
        """Driver/runtime version strings."""

    # -- dynamic reads --------------------------------------------------------

    @abc.abstractmethod
    def read_fields(self, index: int, field_ids: List[int],
                    now: Optional[float] = None) -> Dict[int, FieldValue]:
        """Read current values for ``field_ids`` on chip ``index``.

        Unsupported fields map to ``None``.  ``now`` lets callers pin the
        sample timestamp (used by the watch layer and tests); backends that
        sample hardware ignore it for the read itself.
        """

    def read_fields_bulk(
            self, requests: List[Tuple[int, List[int]]],
            now: Optional[float] = None,
            max_age_s: Optional[float] = None,
    ) -> Dict[int, Dict[int, FieldValue]]:
        """Read fields for many chips in one call: ``[(index, field_ids)]``
        → ``{index: {field_id: value}}``.

        A lost chip is omitted from the result instead of failing the
        sweep — healthy chips keep reporting.  ``max_age_s`` bounds how
        stale a cached value the caller accepts (honored by backends that
        serve from a shared sample cache; live-reading backends ignore it).

        Default loops over :meth:`read_fields`; backends with a wire
        protocol (the agent) override it with a single round trip so a
        full-host sweep costs one RPC, not one per chip.
        """

        del max_age_s  # live reads are always fresh
        out: Dict[int, Dict[int, FieldValue]] = {}
        for idx, fids in requests:
            try:
                out[int(idx)] = self.read_fields(idx, list(fids), now=now)
            except ChipNotFound:
                continue
        return out

    def sweep_fields_bulk(
            self, requests: List[Tuple[int, List[int]]],
            now: Optional[float] = None,
            max_age_s: Optional[float] = None,
            events_since: Optional[int] = None,
    ) -> Tuple[Dict[int, Dict[int, FieldValue]], Optional[List[Event]]]:
        """:meth:`read_fields_bulk` plus an optional piggybacked event
        drain — the whole 1 Hz sweep (values + events with
        ``seq > events_since``) in one backend round trip where the
        transport supports it.

        Returns ``(chips, events)``; ``events is None`` means the backend
        did not drain them and the caller must :meth:`poll_events`
        separately (the default here, and the agent fallback when the
        daemon predates the combined op).
        """

        del events_since
        return (self.read_fields_bulk(requests, now=now,
                                      max_age_s=max_age_s), None)

    def read_burst_fields(self, requests: List[Tuple[int, List[int]]]
                          ) -> Dict[int, Dict[int, FieldValue]]:
        """The burst inner loop's read (:class:`tpumon_torch.burst.
        BurstSampler`, 50-100 Hz) of the burst source fields.  Default:
        :meth:`read_fields_bulk`.  A backend whose read would multiply
        its device work by the inner rate raises ``ValueError``."""

        return self.read_fields_bulk(requests)

    def bus_index(self) -> Dict[Tuple[int, int, int], int]:
        """Each chip's PCI bus key -> its index, so kernel-log evidence
        names the chip.  Default: none known."""

        return {}

    def processes(self, index: int) -> List[DeviceProcess]:
        """Processes currently holding the chip. Default: none visible."""

        return []

    def topology(self, index: int) -> TopologyInfo:
        """Pod-slice topology as seen from chip ``index``."""

        raise BackendError(f"{self.name}: topology not supported")

    # -- events ---------------------------------------------------------------

    def poll_events(self, since_seq: int) -> List[Event]:
        """Events with ``seq > since_seq``, seq-ordered. Default: none.

        The cursor is a sequence number, not a timestamp — equal timestamps
        (coarse clocks) must not drop events.  This pull interface is turned
        into the push-based policy stream by :mod:`tpumon.policy` (the watch
        thread polls at the update frequency).
        """

        return []

    def current_event_seq(self) -> int:
        """Sequence number of the newest event (0 if none) — the cursor a
        new consumer starts from to receive only future events."""

        return 0

    # -- helpers --------------------------------------------------------------

    def now(self) -> float:
        # wall clock on purpose: this is the exported SAMPLE TIMESTAMP
        # (scrape consumers correlate it across hosts), not an interval
        return time.time()  # tpumon-lint: disable=wallclock-in-sampling
