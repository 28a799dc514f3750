"""Self-healing fan-out relay for the streaming plane.

The port's copy of ``tpumon/cli/relay.py``.  Subscribes to an upstream
stream (the exporter daemon's ``--stream-port``, or another relay: trees
compose) and re-serves it to any number of downstream subscribers::

    python -m tpumon_torch.cli.relay --connect origin:9460 --listen-port 9461
    python -m tpumon_torch.cli.relay --connect rack:9461 --listen-unix /run/r.sock
    python -m tpumon_torch.cli.stream --connect pod-relay:9462   # a leaf

Attaches and drop-to-keyframe resyncs are served from the relay's local
mirror: the origin pays for one subscriber per relay, whatever the
subtree size.  Upstream loss degrades the relay (it keeps serving the
last-known state, flagged stale in every tick) and it reconnects under
jittered backoff with a flap circuit breaker; ``--metrics-port`` serves
the ``tpumon_relay_*`` / ``tpumon_stream_*`` families so a degraded or
parked relay is visible, never silent.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional, Sequence, Tuple

from ..relay import StreamRelay, relay_metric_lines
from .common import die


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="tpumon-relay", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--connect", required=True, metavar="ADDR",
                   help="upstream stream endpoint: unix:/path or "
                        "host:port (an exporter --stream-port, or "
                        "another relay)")
    p.add_argument("--stream", default="", metavar="NAME",
                   help="upstream stream name (exporter: leave "
                        "empty); served downstream under the same name")
    p.add_argument("--serve-as", default=None, metavar="NAME",
                   help="serve downstream under a different stream "
                        "name (default: same as --stream)")
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--listen-unix", metavar="PATH",
                   help="serve downstream on a unix socket (a stale "
                        "file from a killed predecessor is rebound — "
                        "the restart contract)")
    g.add_argument("--listen-port", type=int, metavar="PORT",
                   help="serve downstream on TCP")
    p.add_argument("--listen-host", default="", metavar="HOST",
                   help="TCP bind host (default: all interfaces)")
    p.add_argument("--metrics-port", type=int, default=0, metavar="PORT",
                   help="serve tpumon_relay_*/tpumon_stream_* self-"
                        "metrics on this port")
    p.add_argument("--backoff-base", type=float, default=0.5, metavar="S",
                   help="reconnect backoff base seconds (default 0.5)")
    p.add_argument("--backoff-max", type=float, default=30.0, metavar="S",
                   help="reconnect backoff ceiling seconds "
                        "(default 30)")
    p.add_argument("--reconnect-budget", type=int, default=10, metavar="N",
                   help="upstream attachments per budget window before "
                        "the circuit breaker parks the relay "
                        "(0 = never park; default 10)")
    p.add_argument("--budget-window", type=float, default=60.0,
                   metavar="S",
                   help="circuit-breaker window seconds (default 60)")
    p.add_argument("--stale-tick-interval", type=float, default=1.0,
                   metavar="S",
                   help="stale heartbeat cadence while degraded "
                        "(default 1.0)")
    p.add_argument("--stale-after", type=float, default=2.0, metavar="S",
                   help="silent-upstream grace before ticks are "
                        "flagged stale (default 2.0)")
    p.add_argument("--buffer-bytes", type=int, default=1 << 20,
                   metavar="N",
                   help="per-subscriber send-buffer bound "
                        "(default 1 MiB)")
    p.add_argument("--timeout", type=float, default=5.0, metavar="S",
                   help="upstream connect timeout seconds (default 5)")
    args = p.parse_args(argv)

    try:
        relay = StreamRelay(
            args.connect, args.stream, serve_as=args.serve_as,
            listen_unix=args.listen_unix,
            listen_host=args.listen_host or "",
            listen_port=args.listen_port,
            connect_timeout_s=args.timeout,
            backoff_base_s=args.backoff_base,
            backoff_max_s=args.backoff_max,
            reconnect_budget=args.reconnect_budget,
            budget_window_s=args.budget_window,
            stale_tick_interval_s=args.stale_tick_interval,
            stale_after_s=args.stale_after,
            max_buffer_bytes=args.buffer_bytes)
    except (OSError, ValueError) as e:
        die(f"relay setup: {e}")

    metrics_server = None
    try:
        relay.start()
        print(f"# relaying {args.connect} stream {args.stream!r} "
              f"on {relay.address}", file=sys.stderr, flush=True)
        if args.metrics_port:
            from ..httputil import TextHTTPServer

            def dispatch(path: str) -> Tuple[int, str, str]:
                if path != "/metrics":
                    return 404, "text/plain", "not found\n"
                text = "\n".join(relay_metric_lines(relay)) + "\n"
                return 200, "text/plain; version=0.0.4", text

            metrics_server = TextHTTPServer(dispatch, args.metrics_port)
            metrics_server.start()
            print(f"# relay self-metrics on port "
                  f"{metrics_server.port}/metrics", file=sys.stderr,
                  flush=True)
        while True:
            # wall-clock-free foreground wait: the relay thread and
            # the frame server loop do all the work
            time.sleep(3600.0)
    except KeyboardInterrupt:
        return 0
    finally:
        if metrics_server is not None:
            metrics_server.stop()
        relay.close()


if __name__ == "__main__":
    sys.exit(main())
