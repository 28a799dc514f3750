"""tpumon-restapi — entry point.

    python -m tpumon_torch.restapi.main -p 8070

Flag surface mirrors ``samples/dcgm/restApi/main.go:27`` (port :8070
default) plus the standard connection flags.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading
from typing import Optional, Sequence

import tpumon_torch
from ..cli.common import add_connection_flags, die, init_from_args
from .server import RestApi, RestApiServer


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="tpumon-restapi", description=__doc__)
    add_connection_flags(p)
    p.add_argument("-p", "--port", type=int, default=8070)
    p.add_argument("--bind", default="")
    p.add_argument("--process-warmup", type=float, default=3.0,
                   help="seconds of PID-watch warm-up before the first "
                        "process query (default 3, the reference's sleep)")
    args = p.parse_args(argv)

    try:
        h = init_from_args(args)
    except tpumon_torch.BackendError as e:
        die(str(e))
    try:
        api = RestApi(h, process_warmup_s=args.process_warmup)
        srv = RestApiServer(api, port=args.port, bind=args.bind)
        srv.start()
        # stop in a finally from here on: a raise after start (signal
        # wiring, an interrupted wait) must still release the server
        # socket and reap the serve thread
        try:
            print(f"tpumon-restapi listening on :{srv.port}")
            sys.stdout.flush()
            stop = threading.Event()
            signal.signal(signal.SIGINT, lambda *_: stop.set())
            signal.signal(signal.SIGTERM, lambda *_: stop.set())
            stop.wait()
        finally:
            srv.stop()
    finally:
        tpumon_torch.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
