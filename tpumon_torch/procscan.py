"""Device-holder discovery via /proc — shared by backends.

A copy of ``tpumon/procscan.py``, imports renamed; the port's NVML
backend passes ``/dev/nvidia<minor>``.

The Python sibling of the agent's fd scan (``native/agent/main.cc``,
``list_device_holders``): walk ``/proc/<pid>/fd`` symlinks looking for open
handles on a chip's device node, then read ``/proc/<pid>/comm`` for the
process name.  Role analog of NVML's running-process enumeration +
``/proc/<pid>/comm`` read (``bindings/go/nvml/bindings.go:527-582,637-649``)
— on TPU there is no driver call for this, but the kernel knows who holds
``/dev/accel*``.

Needs no privileges for same-user processes; fds of other users' processes
are silently skipped (EACCES), which matches the monitor's typical DaemonSet
deployment where it runs privileged anyway.
"""

from __future__ import annotations

import os
from typing import List

from .types import DeviceProcess


def comm_of(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/comm", "r") as f:
            return f.read().strip()
    except OSError:
        return ""


def holders_of(dev_path: str) -> List[DeviceProcess]:
    """PIDs with an open fd on ``dev_path``, name-annotated, pid-ordered."""

    if not dev_path:
        return []
    out: List[DeviceProcess] = []
    try:
        pids = [int(e) for e in os.listdir("/proc") if e.isdigit()]
    except OSError:
        return []
    for pid in sorted(pids):
        fd_dir = f"/proc/{pid}/fd"
        try:
            fds = os.listdir(fd_dir)
        except OSError:
            continue  # vanished or not ours
        for fd in fds:
            try:
                target = os.readlink(os.path.join(fd_dir, fd))
            except OSError:
                continue
            if target == dev_path:
                out.append(DeviceProcess(pid=pid, name=comm_of(pid)))
                break
    return out
