"""tpu-pod-metrics-exporter — standalone pod-attribution daemon.

The port's copy of ``tpumon/exporter/pod_main.py``
(``python -m tpumon_torch.exporter.pod_main``); pod labels come from
:mod:`.pod_attrib`'s GPU lookup.  Analog of the reference's
``pod-gpu-metrics-exporter`` (SURVEY §2.8): watch
the exporter's textfile, splice pod labels from the kubelet, publish the
enriched file, serve it over HTTP.

Contracts kept from the reference:
* path hand-off: input ``/run/prometheus/tpu.prom`` -> output
  ``/run/tpumon/tpu-pod.prom`` (``watchers.go:15-21``);
* change detection on the producer's atomic rename (here: mtime/inode
  polling — the portable equivalent of the fsnotify CREATE filter,
  ``watchers.go:38-51``);
* liveness watchdog: fatal exit after 10 minutes without input changes so
  the container restarts (``watchers.go:57-59``);
* HTTP ``GET /tpu/metrics`` (and the legacy ``/gpu/metrics`` path) serving
  the enriched file bytes (``http.go:44-52``).

This daemon exists for deployments that keep the exporter and attribution
in separate containers (the reference's two-DaemonSet layout); single-
process deployments use ``prometheus-tpu --pod-labels`` instead.
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import time

from .. import log
from ..httputil import TextHTTPServer
from .pod_attrib import PodAttributor
from .promtext import atomic_write

DEFAULT_INPUT = "/run/prometheus/tpu.prom"
DEFAULT_OUTPUT = "/run/tpumon/tpu-pod.prom"
WATCHDOG_S = 600.0  # watchers.go:57-59


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpu-pod-metrics-exporter",
                                description=__doc__)
    p.add_argument("--input", default=DEFAULT_INPUT)
    p.add_argument("--output", default=DEFAULT_OUTPUT)
    p.add_argument("--port", type=int, default=9400)
    p.add_argument("--kubelet-socket", default=None)
    p.add_argument("--poll", type=float, default=0.2,
                   help="input poll interval seconds")
    p.add_argument("--watchdog", type=float, default=WATCHDOG_S,
                   help="exit fatally after SEC without input changes "
                        "(0 disables)")
    p.add_argument("--oneshot", action="store_true",
                   help="enrich once, print to stdout, exit")
    p.add_argument("--v", type=int, default=None, metavar="N",
                   help="log verbosity (glog-style -v, src/main.go:18-33)")
    args = p.parse_args(argv)
    if args.v is not None:
        log.set_verbosity(args.v)

    attributor = PodAttributor(socket_path=args.kubelet_socket)
    state = {"text": "", "last_change": time.monotonic()}
    lock = threading.Lock()

    def process_once() -> bool:
        try:
            with open(args.input) as f:
                text = f.read()
        except OSError:
            return False
        enriched = attributor.enrich(text)
        with lock:
            state["text"] = enriched
            state["last_change"] = time.monotonic()
        atomic_write(args.output, enriched)
        return True

    if args.oneshot:
        if not process_once():
            print(f"error: cannot read {args.input}", file=sys.stderr)
            return 1
        with lock:
            sys.stdout.write(state["text"])
        return 0

    def dispatch(path: str):
        if path in ("/tpu/metrics", "/gpu/metrics", "/metrics"):
            with lock:
                return 200, "text/plain; version=0.0.4", state["text"]
        return 404, "text/plain", "not found\n"

    server = TextHTTPServer(dispatch, port=args.port)
    server.start()

    last_sig = None
    try:
        while True:
            try:
                st = os.stat(args.input)
                sig = (st.st_mtime_ns, st.st_ino, st.st_size)
            except OSError:
                sig = None
            if sig is not None and sig != last_sig:
                if process_once():
                    last_sig = sig
            with lock:
                idle = time.monotonic() - state["last_change"]
            if args.watchdog and idle > args.watchdog:
                # container-restart recovery path (watchers.go:57-59)
                log.error("no metric updates for %.0fs; exiting for "
                          "container restart", idle)
                return 1
            time.sleep(args.poll)
    except KeyboardInterrupt:
        return 0
    finally:
        server.stop()


if __name__ == "__main__":
    sys.exit(main())
