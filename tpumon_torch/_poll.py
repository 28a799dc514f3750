"""Loader for the port's native poll engine (``_tpumon_torch_poll``).

The :class:`tpumon_torch.fleetpoll.FleetPoller` inner loop — epoll
event loop, non-blocking sockets, per-connection state machines, frame
reassembly and the native-owned delta tables — has a C++ twin built as
its own CPython extension (``native/poll/``; built by ``python -m
tpumon_torch._build --native``).  When it is loaded,
:func:`tpumon_torch.fleetpoll.create_fleet_poller` drives the fleet
through it with the GIL released for the whole tick; when it is not, the
pure-Python poller serves (identical samples, held to each other and to
the JAX package's poller by ``tests/test_torch_fleet_native.py``).

A separate extension from ``_tpumon_torch_codec``, as in the reference:
the codec is portable, the engine is Linux/epoll-only (elsewhere the
extension builds as a stub exporting ``ENGINE_AVAILABLE = 0`` and no
``PollEngine``).  Only the build of the current sources is loaded, as
:mod:`tpumon_torch._codec` says.

Env override ``TPUMON_NATIVE`` (same convention as ``_codec``):

* ``0`` — never load the extension (force the pure-Python poller);
* ``1`` — fail loudly (ImportError) if the extension is not built or
  is rejected;
* unset/other — load it when it is built, fall back silently otherwise.
"""

from __future__ import annotations

import os
from typing import Any, Optional

from . import _build

#: the extension's module (and build target) name
NAME = "_tpumon_torch_poll"
_FORCED = os.environ.get("TPUMON_NATIVE", "").strip()
#: the loaded extension module, or None (pure-Python fallback), and the
#: human-readable reason when it is None (for logs / self-metrics)
lib: Optional[Any]
error: str


def active() -> bool:
    """True when the native engine is loaded (the ``tpumon_poll_native``
    gauge is this plus the platform gate in ``fleetpoll``)."""

    return lib is not None


def reject(reason: str) -> None:
    """Refuse the loaded extension (constant mismatch / platform
    without epoll): fall back to the pure-Python poller, or raise when
    ``TPUMON_NATIVE=1``."""

    global lib, error
    if _FORCED == "1":
        raise ImportError(f"TPUMON_NATIVE=1 but the native poll engine "
                          f"was rejected: {reason}")
    lib = None
    error = reason


lib, error = _build.load_selected(NAME, "native poll engine")
