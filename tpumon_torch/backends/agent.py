"""Addresses of the metrics agent's and the stream plane's sockets.

The first part of the port's copy of ``tpumon/backends/agent.py``: the
address rule (``unix:/path/to.sock`` or ``host:port``) that the stream
subscriber (:mod:`tpumon_torch.cli.stream`) dials by.  The agent client
itself (``AgentBackend``, the ``--connect``/``--start-agent`` run modes)
is not ported yet: ROADMAP.md, Queue 1, item 16b, part 5.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

DEFAULT_SOCKET = "/tmp/tpumon-hostengine.sock"
DEFAULT_TCP_PORT = 5555  # same default port role as nv-hostengine


def _parse_address(address: Optional[str]) -> Tuple[str, Any]:
    addr = address or f"unix:{DEFAULT_SOCKET}"
    if addr.startswith("unix:"):
        return "unix", addr[len("unix:"):]
    if ":" in addr:
        host, port = addr.rsplit(":", 1)
        return "tcp", (host, int(port))
    return "tcp", (addr, DEFAULT_TCP_PORT)
