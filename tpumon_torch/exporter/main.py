"""prometheus-tpu — the exporter daemon's entry point, on the GPU.

    python -m tpumon_torch.exporter.main -o /run/prometheus/tpu.prom \\
        -d 1000 --port 9400 --pod-labels --wait-for-tpu=-1 \\
        --merge-textfile '/run/tpumon-drop/*.prom'

The port's copy of ``tpumon/exporter/main.py``, with the same flag
surface, so one argv drives either CLI.  The flag surface mirrors the
reference's ``dcgm-exporter`` getopt block (``dcgm-exporter:5-34``):
``-o`` output file, ``-d`` interval ms (floor 10; the reference's is
100), ``-p`` profiling metrics; plus a native HTTP port the reference
delegated to node-exporter (``/metrics``, ``/tpu/metrics``,
``/healthz``), the textfile merge, and kubelet pod attribution.

The source is ``tpumon_torch.init()`` on the default ``auto`` backend,
which is NVML, or the agent with ``--connect ADDR``/``--start-agent``
(``gpu-hostengine``; the device is then read in the agent and
the daemon samples through its watch): the daemon never imports
``torch`` and never creates a CUDA context.  ``--wait-for-tpu S`` retries the NVML init every 2 s for
up to S seconds (-1 = forever) before it exits 1; nothing else is ever
served in its place.

The planes the deployed configuration turns off run as in the
reference: ``--burst-hz HZ`` (the burst inner loop over NVML; implies
``--burst``), ``--blackbox-dir DIR`` (the flight recorder; replay it with
``python -m tpumon_torch.cli.replay``) and ``--rules FILE`` (the anomaly
plane); with either of the last two, kernel-log lines ride in through a
kmsg watcher where ``/dev/kmsg`` can be read.  ``--stream-port P`` serves
the live stream plane (subscribe with ``python -m tpumon_torch.cli.stream
--connect HOST:P`` or ``GET /stream``).  ``--ici-per-link-modeled``
serves the per-link NVLink families as an even split of the measured
aggregate (the collective attribution), labeled ``source="modeled"``.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading
import time

import tpumon_torch
from .. import log
from ..cli.common import add_connection_flags, die, init_from_args
from .exporter import (DEFAULT_OUTPUT, DEFAULT_PORT, MIN_INTERVAL_MS,
                       MetricsHTTPServer, TpuExporter)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="prometheus-tpu", description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    add_connection_flags(p)
    p.add_argument("-o", "--output", default=DEFAULT_OUTPUT,
                   help=f"textfile path (default {DEFAULT_OUTPUT}); "
                        "'none' disables the textfile")
    p.add_argument("-d", "--delay", type=int, default=1000, metavar="MS",
                   help="collect interval in ms (default 1000, min 10; "
                        "the reference's floor is 100)")
    p.add_argument("-p", "--profiling", action="store_true",
                   help="add profiling families (DCP-fields analog)")
    p.add_argument("-e", "--fields", default=None, metavar="IDS",
                   help="comma list of field ids or names, replacing the "
                        "default set (dcgmi dmon -e analog), e.g. "
                        "'155,150,tpu_hbm_used'")
    p.add_argument("--dcn", action="store_true",
                   help="add multi-slice DCN families")
    p.add_argument("--burst", action="store_true",
                   help="add the burst-derived 1s min/max/mean/integral "
                        "families (blank unless --burst-hz runs the "
                        "inner loop)")
    p.add_argument("--burst-hz", type=int, default=0, metavar="HZ",
                   help="run the burst inner loop at HZ (50-100 typical; "
                        "0 = off) over the NVML backend; implies --burst")
    p.add_argument("--port", type=int, default=DEFAULT_PORT,
                   help=f"HTTP /metrics port (default {DEFAULT_PORT}; "
                        "0 disables)")
    p.add_argument("--pod-labels", action="store_true",
                   help="splice pod/namespace/container labels from the "
                        "kubelet pod-resources socket (or the map file "
                        "named by TPUMON_POD_MAP_FILE)")
    p.add_argument("--kubelet-socket", default=None,
                   help="pod-resources socket path override")
    p.add_argument("--merge-textfile", action="append", default=[],
                   metavar="GLOB",
                   help="merge fresh .prom files matching GLOB into every "
                        "sweep (repeatable) — the textfile-collector role: "
                        "serve a workload's embedded self-monitor output "
                        "without touching the device")
    p.add_argument("--merge-max-age", type=float, default=60.0, metavar="S",
                   help="skip merge files older than S seconds "
                        "(default 60; a dead workload must not be served "
                        "forever)")
    p.add_argument("--ici-per-link-modeled", action="store_true",
                   default=os.environ.get(
                       "TPUMON_ICI_PER_LINK_MODELED") == "1",
                   help="synthesize per-link NVLink families as an even "
                        "split of the measured aggregate over the card's "
                        "NVLink peers, labeled source=\"modeled\" (no "
                        "real per-link source in embedded mode; off by "
                        "default)")
    p.add_argument("--blackbox-dir", default=None, metavar="DIR",
                   help="flight recorder: tee every sweep's delta frame "
                        "(plus kmsg lines) into bounded on-disk segments "
                        "under DIR; replay with python -m "
                        "tpumon_torch.cli.replay")
    p.add_argument("--blackbox-max-bytes", type=int, default=None,
                   metavar="N",
                   help="flight recorder disk budget in bytes "
                        "(default 64 MiB; oldest segments reclaimed "
                        "first)")
    p.add_argument("--rules", default=None, metavar="FILE",
                   help="streaming anomaly detection: load a versioned "
                        "rules.yaml (per-series detectors + cross-signal "
                        "incident rules) and score every sweep's changed "
                        "values in-process; findings surface as "
                        "tpumon_anomaly_*/tpumon_incident_* families and "
                        "flight-recorder records.  Validate a rule change "
                        "against recorded history with python -m "
                        "tpumon_torch.cli.replay --backtest FILE")
    p.add_argument("--stream-port", type=int, default=0, metavar="N",
                   help="live streaming subscription plane: push every "
                        "sweep's encoded delta frame to N concurrent "
                        "subscribers on this TCP port (0 disables; "
                        "subscribe with python -m tpumon_torch.cli.stream "
                        "or GET /stream)")
    p.add_argument("--oneshot", action="store_true",
                   help="single sweep, print to stdout, exit")
    p.add_argument("--wait-for-tpu", type=float, default=0.0, metavar="S",
                   help="retry the NVML init every 2 s for up to S seconds "
                        "before giving up (-1 = forever) — the reference's "
                        "readiness gate (dcgm-exporter:45-48); "
                        "default 0 fails fast")
    args = p.parse_args(argv)

    if args.delay < MIN_INTERVAL_MS:
        die(f"minimum collect interval is {MIN_INTERVAL_MS} ms")

    deadline = (None if args.wait_for_tpu < 0
                else time.monotonic() + args.wait_for_tpu)
    while True:
        try:
            h = init_from_args(args)
            break
        except tpumon_torch.BackendError as e:
            if deadline is not None and time.monotonic() >= deadline:
                die(str(e))
            print(f"prometheus-tpu: waiting for the GPU stack: {e}",
                  file=sys.stderr, flush=True)
            pause = 2.0
            if deadline is not None:
                pause = min(pause, max(0.0, deadline - time.monotonic()))
            time.sleep(pause)

    output = None if args.output == "none" else args.output
    field_ids = None
    # pre-bound so the failed-start teardown below can always tell what
    # was already wired (a constructor raising early leaves the rest None)
    exporter = None
    http = None
    stream_server = None
    kmsg_watcher = None
    try:
        if args.fields:
            from .. import fields as FF
            field_ids = []
            for part in args.fields.split(","):
                part = part.strip()
                if part.isdigit():
                    field_ids.append(int(part))
                else:
                    m = FF.by_name(part)
                    if m is None:
                        die(f"unknown field {part!r}")
                    field_ids.append(m.field_id)
        rules = None
        if args.rules:
            from ..anomaly import load_rules
            try:
                rules = load_rules(args.rules)
            except (OSError, ValueError) as e:
                die(str(e))
        try:
            exporter = TpuExporter(h, interval_ms=args.delay,
                                   profiling=args.profiling, dcn=args.dcn,
                                   burst=args.burst,
                                   burst_hz=args.burst_hz,
                                   field_ids=field_ids,
                                   output_path=output,
                                   merge_globs=args.merge_textfile,
                                   merge_max_age_s=args.merge_max_age,
                                   ici_per_link_modeled=(
                                       args.ici_per_link_modeled),
                                   blackbox_dir=args.blackbox_dir,
                                   blackbox_max_bytes=args.blackbox_max_bytes,
                                   rules=rules)
        except ValueError as e:
            die(str(e))
        if not exporter.chips:
            die("no chips selected (check TPUMON_CHIPS / NODE_NAME env)")

        if args.pod_labels:
            from .pod_attrib import PodAttributor
            # 30 s kubelet cadence: pods do not churn faster, and the RPC
            # runs on the sweep thread, so it must stay far off the sweep
            # cadence
            attributor = PodAttributor(socket_path=args.kubelet_socket,
                                       refresh_s=30.0)
            exporter.set_pod_attributor(attributor)

        if args.oneshot:
            sys.stdout.write(exporter.sweep())
            exporter.stop()
            return 0

        log.info("prometheus-tpu: backend=%s chips=%s interval=%dms "
                 "output=%s", h.backend.name, list(exporter.chips),
                 args.delay, output or "-")
        if args.port:
            http = MetricsHTTPServer(exporter, port=args.port)
            http.start()
            log.info("prometheus-tpu: serving /metrics on :%d", args.port)

        # live streaming plane: one selector-driven FrameServer pushes
        # each sweep's already-encoded delta frame to every subscriber
        if args.stream_port:
            from ..frameserver import FrameServer, StreamHub
            stream_server = FrameServer()
            hub = StreamHub(stream_server)
            addr = stream_server.add_tcp_listener(
                hub, host="", port=args.stream_port)
            exporter.set_stream_publisher(hub.publisher(""))
            stream_server.start()
            log.info("prometheus-tpu: streaming sweep frames on %s "
                     "(subscribe: python -m tpumon_torch.cli.stream "
                     "--connect)", addr)

        # kernel-log lines ride into the black box next to the sweep
        # frames AND feed the detection plane's incident joins.
        # Best-effort — no /dev/kmsg (an unprivileged container, the
        # card's sandbox) just means no kmsg records and no kmsg-side
        # evidence.
        if exporter.blackbox is not None or exporter.anomaly is not None:
            from ..kmsg import KmsgWatcher
            bb = exporter.blackbox
            exp = exporter

            def _kmsg_sink(chip: int, etype: int, ts: float,
                           msg: str) -> None:
                # when the engine is armed, the sweep thread records the
                # line at drain time (queue accepted -> True) so disk
                # order == live scoring order; otherwise (or on a full
                # queue) record directly, keeping the evidence
                if not exp.anomaly_kmsg(msg, ts) and bb is not None:
                    bb.record_kmsg(msg, now=ts)

            kmsg_watcher = KmsgWatcher(sink=_kmsg_sink,
                                       buses=h.backend.bus_index())
            if kmsg_watcher.start():
                log.info("prometheus-tpu: feeding kmsg lines from %s to "
                         "the flight recorder / detection plane",
                         kmsg_watcher.path)
            else:
                log.info("prometheus-tpu: no kernel log at %s; the "
                         "planes run without kmsg lines",
                         kmsg_watcher.path)
                kmsg_watcher = None

        stop = threading.Event()
        signal.signal(signal.SIGINT, lambda *_: stop.set())
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
        exporter.start()
        stop.wait()
        # kmsg first: a kernel line landing after exporter.stop() has
        # closed the recorder would reopen a segment nothing closes
        if kmsg_watcher is not None:
            kmsg_watcher.stop()
        exporter.stop()
        if http:
            http.stop()
        if stream_server is not None:
            stream_server.close()
    except BaseException:
        # a failed wiring step (port in use, ...) must not leak what
        # already started: release in the normal teardown order,
        # best-effort, then let the error surface
        if kmsg_watcher is not None:
            try:
                kmsg_watcher.stop()
            except Exception as e:
                log.warning("kmsg stop after failed start: %r", e)
        if exporter is not None:
            try:
                exporter.stop()
            except Exception as e:
                log.warning("exporter stop after failed start: %r", e)
        if http is not None:
            try:
                http.stop()
            except Exception as e:
                log.warning("http stop after failed start: %r", e)
        if stream_server is not None:
            try:
                stream_server.close()
            except Exception as e:
                log.warning("stream close after failed start: %r", e)
        raise
    finally:
        tpumon_torch.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
