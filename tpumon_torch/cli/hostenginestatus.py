"""tpumon-hostengine-status — monitor self-metrics.

The port's copy of ``tpumon/cli/hostenginestatus.py`` (``python -m
tpumon_torch.cli.hostenginestatus [--connect ADDR]``): the agent's
introspection over ``--connect``/``--start-agent``, else the embedded
engine's.  Analog of ``samples/dcgm/hostengineStatus/main.go`` (dcgmi
introspect --hostengine; memory + CPU of the metrics engine,
``samples/dcgm/README.md:106-107``): the probe for the north star's <1%
host CPU.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import tpumon_torch

from .common import add_connection_flags, die, init_from_args


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="tpumon-hostengine-status",
                                description=__doc__)
    add_connection_flags(p)
    args = p.parse_args(argv)

    try:
        h = init_from_args(args)
    except tpumon_torch.BackendError as e:
        die(str(e))
    try:
        from tpumon_torch.backends.agent import AgentBackend
        if isinstance(h.backend, AgentBackend):
            d = h.backend.agent_introspect()
            print(f"Engine       : tpu-hostengine (pid {d.get('pid')})")
            print(f"Memory       : {d.get('memory_kb', 0):.0f} KB")
            print(f"CPU          : {d.get('cpu_percent', 0):.3f} %")
            print(f"Uptime       : {d.get('uptime_s', 0):.1f} s")
            print(f"Requests     : {d.get('requests', 0)}")
            print(f"Samples      : {d.get('samples', 0)}")
        else:
            st = h.introspect()
            print(f"Engine       : embedded (pid {st.pid})")
            print(f"Memory       : {st.memory_kb:.0f} KB")
            print(f"CPU          : {st.cpu_percent:.3f} %")
            print(f"Uptime       : {st.uptime_s:.1f} s")
            print(f"Samples/sec  : {st.samples_per_second:.1f}")
    finally:
        tpumon_torch.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
