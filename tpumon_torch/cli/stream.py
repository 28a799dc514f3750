"""tpumon-stream — live subscriber to the streaming sweep plane.

The port's copy of ``tpumon/cli/stream.py``.  The exporter daemon
(``python -m tpumon_torch.exporter.main --stream-port P``) pushes every
sweep's already-encoded ``sweep_frame`` delta bytes to any number of
subscribers (:mod:`tpumon_torch.frameserver`).  This tool is one such
subscriber: it attaches (receiving a keyframe — the full current state —
then live deltas), decodes the stream, and renders each tick::

    python -m tpumon_torch.cli.stream --connect myhost:9460

This costs the server no render or scrape work per subscriber — the
bytes on the wire are the same delta frames the flight recorder writes,
encoded once per sweep for ALL subscribers.  ``python -m
tpumon_torch.cli.replay --follow`` is the file-based twin (same record
stream, read from the black box instead of a socket).

Output formats (shared with ``tpumon_torch.cli.replay``):

* ``table`` (default) — one per-chip table per tick.
* ``promtext`` — each tick's snapshot as a Prometheus exposition.
* ``json`` — one JSON object per line per tick/event (machine tail).

If the stream falls behind (this process too slow to read), the
server drops it to a keyframe rather than buffering unboundedly; the
resync is visible as ``keyframe: true`` on a mid-run tick.
"""

from __future__ import annotations

import argparse
import json
import random
import socket
import sys
import time
from typing import Optional, Sequence

from ..backends.agent import _parse_address
from ..blackbox import ReplayTick
from ..frameserver import StreamDecoder
from .common import die, epipe_safe
from .replay import _emit_item


def _connect(address: str, timeout_s: float) -> socket.socket:
    kind, target = _parse_address(address)
    if kind == "unix":
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    else:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        s.settimeout(timeout_s)
        s.connect(target)
        # attached: from here on the server pushes at the sweep
        # cadence — block indefinitely between ticks
        s.settimeout(None)
    except BaseException:
        s.close()  # a refused attach must not leak the socket
        raise
    return s


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="tpumon-stream", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--connect", required=True, metavar="ADDR",
                   help="stream endpoint: unix:/path or host:port "
                        "(the --stream-port of an exporter or fleet "
                        "poller)")
    p.add_argument("--stream", default="", metavar="NAME",
                   help="stream name (exporter: leave empty; fleet "
                        "poller: the target host address)")
    p.add_argument("--format", choices=("table", "promtext", "json"),
                   default="table", help="output format (default table)")
    p.add_argument("-c", "--count", type=int, default=None, metavar="N",
                   help="exit after N ticks (default: stream forever)")
    p.add_argument("--retry", action="store_true",
                   help="on upstream EOF/connection loss, reconnect "
                        "with jittered backoff and resync via the "
                        "fresh attach keyframe instead of exiting "
                        "(prints a '# reconnected' marker line); "
                        "incompatible with --count — a resync makes "
                        "'N ticks' ill-defined")
    p.add_argument("--timeout", type=float, default=5.0, metavar="S",
                   help="connect timeout seconds (default 5)")
    args = p.parse_args(argv)
    if args.retry and args.count is not None:
        # ticks replayed by a post-resync keyframe are not the ticks
        # that were missed: "exit after N" cannot survive a resync
        p.error("--retry cannot be combined with --count")

    class _Done(Exception):
        """--count satisfied."""

    # --retry backoff state, shared with serve_one: reset on received
    # DATA, not on connect success — a dead-but-accepting upstream
    # (accepts, EOFs before a frame) must keep doubling toward the
    # ceiling instead of hot-dialing at the base forever (the same
    # policy StreamRelay applies)
    retry_state = {"backoff": 0.0}
    #: real ticks printed so far, the unit of --count
    printed = [0]

    def serve_one(sock: socket.socket, reconnected: bool) -> None:
        """Stream one connection until --count is satisfied (_Done)
        or the connection is lost (EOFError: clean close; OSError:
        error/desync) — the caller's retry policy decides what loss
        means."""

        decoder = StreamDecoder()
        try:
            sock.sendall(json.dumps(
                {"op": "stream", "stream": args.stream},
                separators=(",", ":")).encode() + b"\n")
            while True:
                chunk = sock.recv(65536)
                if not chunk:
                    raise EOFError(
                        "stream closed before the first tick "
                        "(wrong --stream name?)" if decoder.ticks == 0
                        else "stream closed by server")
                if decoder.ticks == 0 and decoder.header is None \
                        and chunk[:1] == b"{":
                    # subscribe refused: the reply is a JSON error
                    # line — a WRONG name is fatal even under --retry
                    # (reconnecting cannot fix it)
                    err = chunk.split(b"\n", 1)[0].decode(
                        "utf-8", "replace")
                    try:
                        die(str(json.loads(err).get("error", err)))
                    except ValueError:
                        die(err)
                if reconnected:
                    # past the refused-subscribe check: this chunk is
                    # stream data on the fresh connection
                    print("# reconnected — resynced via fresh "
                          "keyframe", file=sys.stderr, flush=True)
                    reconnected = False
                try:
                    for item in decoder.feed(chunk):
                        _emit_item(item, args.format)
                        # a decoded item is real progress: only now
                        # does the retry backoff reset (a header-only
                        # connection must keep doubling)
                        retry_state["backoff"] = 0.0
                        # --count counts REAL frames as they are
                        # printed: anomaly records ride between ticks
                        # and a degraded relay's frameless stale
                        # heartbeats repeat last-known state — neither
                        # is one of the N samples the caller asked for.
                        # (decoder.ticks counts a whole chunk's frames
                        # before the first is printed: the reference
                        # stops early when frames arrive together.)
                        if isinstance(item, ReplayTick) and \
                                not item.stale:
                            printed[0] += 1
                        if args.count is not None and \
                                printed[0] >= args.count:
                            raise _Done()
                except ValueError as e:
                    # desynchronized stream: drop the connection; the
                    # re-attach keyframe makes recovery exact
                    raise OSError(f"desynchronized stream: {e}") \
                        from None
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def body() -> int:
        lost = False
        while True:
            reason: object
            try:
                sock = _connect(args.connect, args.timeout)
            except OSError as e:
                if not args.retry:
                    die(f"connect to {args.connect}: {e}")
                reason = e
            else:
                try:
                    serve_one(sock, reconnected=lost)
                except _Done:
                    return 0
                except EOFError as e:
                    if not args.retry:
                        if str(e).startswith("stream closed before"):
                            die(str(e))
                        print(f"# {e}", file=sys.stderr)
                        return 0
                    reason = e
                except OSError as e:
                    if not args.retry:
                        die(str(e))
                    reason = e
            # --retry: jittered exponential backoff, marker on stderr;
            # the re-attach keyframe (a fresh StreamDecoder starts a
            # SweepFrameDecoder in adopt_first_index mode) resyncs
            lost = True
            retry_state["backoff"] = min(
                max(retry_state["backoff"] * 2.0, 0.5), 30.0)
            delay = retry_state["backoff"] * random.uniform(0.5, 1.0)
            print(f"# upstream lost ({reason}); reconnecting in "
                  f"{delay:.1f}s", file=sys.stderr, flush=True)
            time.sleep(delay)

    return epipe_safe(body)


if __name__ == "__main__":
    sys.exit(main())
