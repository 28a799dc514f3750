"""tpumon-fleet — fleet-wide view across many per-host agents.

The port's copy of ``tpumon/cli/fleet.py``, imports renamed.  One table
per tick with a row per host (from that host's agent: ``python -m
tpumon_torch.hostengine`` on a GPU host) and an aggregate row::

    python -m tpumon_torch.cli.fleet --connect unix:/tmp/a.sock -c 3
    python -m tpumon_torch.cli.fleet --targets-file hosts.txt --once --check \
        --expect-chips 8
    python -m tpumon_torch.cli.fleet --targets-file hosts.txt --shards 4 \
        --supervise --metrics-port 9480

The sweep is driven by :class:`tpumon_torch.fleetpoll.FleetPoller`: ONE
event loop multiplexing all hosts over non-blocking sockets, with
``hello`` asked once per *connection* instead of once per host-tick.
Down hosts back off exponentially under a per-tick reconnect budget, so
one flapping rack cannot starve the healthy rows.  ``--shards N`` splits
the loop over N in-process shards, ``--supervise`` runs each shard as a
supervised child process (:mod:`tpumon_torch.supervisor`).

Targets come from repeated ``--connect`` flags or ``--targets-file``
(one address per line, ``#`` comments).  An unreachable host renders as
a DOWN row — a fleet view that dies when one host does is useless
during the exact incident it exists for.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .. import fields as FF
from ..fleetpoll import (FleetPoller, HostSample, aggregate_host_sample,
                         create_fleet_poller)
from .common import die, epipe_safe, ticker

F = FF.F

#: per-sweep field set (one bulk RPC per host)
_FIELDS = [int(F.POWER_USAGE), int(F.CORE_TEMP), int(F.TENSORCORE_UTIL),
           int(F.HBM_BW_UTIL), int(F.HBM_USED), int(F.HBM_TOTAL),
           int(F.ICI_LINKS_UP)]


class HostConn:
    """One host's AgentBackend, kept open across ticks — the blocking
    compat shim for ad-hoc callers and tests (the fleet CLI itself runs
    on :class:`tpumon_torch.fleetpoll.FleetPoller`).

    At a 1 s tick, reconnecting per sweep is pure waste — and under
    load the extra connect handshakes show up as fake DOWN flaps
    exactly when the fleet view matters.  A REUSED connection that
    fails mid-sample gets exactly one fresh-connection retry within
    the tick, charged against the REMAINING per-host deadline (the
    agent may simply have restarted, or an idle socket was reaped,
    between ticks — a healthy host must not render DOWN for that, but
    a dead one must not cost 2x the budget either); a fresh
    connection's failure is reported as-is.  Each target is sampled by
    at most one thread per tick (the sweep is synchronous), so no lock
    is needed."""

    def __init__(self, address: str) -> None:
        self.address = address
        self._backend = None

    # tpumon: thread-ok(one sampler per host per tick — the sweep is synchronous: each target's sample runs on one pool thread, and close runs after the pool has drained)
    def close(self) -> None:
        b, self._backend = self._backend, None
        if b is not None:
            try:
                b.close()
            # tpumon: close-ok(teardown best-effort: a secondary close error must not mask the sample error path that triggered the reconnect)
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass

    # tpumon: thread-ok(one sampler per host per tick — the sweep is synchronous: each target's sample runs on one pool thread, and close runs after the pool has drained)
    def _connect(self, timeout_s: float) -> Any:
        from ..backends.agent import AgentBackend

        b = AgentBackend(address=self.address, timeout_s=timeout_s,
                         connect_retry_s=0.0)
        try:
            b.open()
        except BaseException:
            # a failed open must release whatever partial connection
            # the backend holds — the next tick builds a fresh one
            b.close()
            raise
        self._backend = b
        return b

    # tpumon: thread-ok(one sampler per host per tick — the sweep is synchronous: each target's sample runs on one pool thread, and close runs after the pool has drained)
    def sample(self, timeout_s: float) -> HostSample:
        t0 = time.monotonic()
        b = self._backend
        reused = b is not None
        try:
            if b is None:
                b = self._connect(timeout_s)
        except Exception as e:
            self._backend = None
            return HostSample(address=self.address, up=False, error=str(e))
        try:
            return self._read(b)
        except Exception as e:
            # drop the broken connection rather than retrying a dead
            # socket on later ticks
            self.close()
            if not reused:
                return HostSample(address=self.address, up=False,
                                  error=str(e))
            first_err = e
        # the kept socket died between ticks: one in-tick retry on a
        # fresh connection before declaring the host DOWN — charged
        # against the deadline the caller already spent part of, so a
        # dead kept socket can never cost 2x the per-host budget
        remaining = timeout_s - (time.monotonic() - t0)
        if remaining <= 0:
            return HostSample(
                address=self.address, up=False,
                error=f"deadline exhausted before retry: {first_err}")
        try:
            b = self._connect(remaining)
            s = self._read(b)
        except Exception as e:
            self.close()
            return HostSample(address=self.address, up=False, error=str(e))
        # the retried connection survives into later ticks: restore the
        # caller's full per-tick budget on it (the truncated timeout was
        # this tick's remaining allowance, not the connection's)
        b.timeout_s = timeout_s
        sock = getattr(b, "_sock", None)
        if sock is not None:
            try:
                sock.settimeout(timeout_s)
            except OSError:
                pass
        return s

    def _read(self, b) -> HostSample:
        # one hello carries chip count + versions (chip count can
        # change across agent restarts, so the blocking shim re-asks
        # per tick over the kept connection; the multiplexer caches it
        # per connection instead)
        hello = b._call("hello")
        n = int(hello["chip_count"])
        per_chip = b.read_fields_bulk([(c, _FIELDS) for c in range(n)])
        return aggregate_host_sample(self.address, n,
                                     hello.get("driver", ""), per_chip,
                                     b.current_event_seq())


def sample_host(address: str, timeout_s: float) -> HostSample:
    """One-shot sample (tests / ad-hoc callers): connect, sample, close."""

    conn = HostConn(address)
    try:
        return conn.sample(timeout_s)
    finally:
        conn.close()


class ThreadPoolSweeper:
    """Thread-per-host compat sweeper over :class:`HostConn` — the
    pre-multiplexer plane, kept for ad-hoc callers and as the baseline
    the multiplexer is measured against.  One pool for the sweeper's lifetime (never recreated per
    tick) sized from ``len(targets)`` — the old hard-coded
    ``min(32, ...)`` cap silently serialized fleets larger than 32
    hosts into waves; reproduce it only via ``max_workers`` when
    measuring that baseline on purpose."""

    def __init__(self, targets: Sequence[str], timeout_s: float,
                 max_workers: Optional[int] = None) -> None:
        self._timeout_s = timeout_s
        self.conns = [HostConn(t) for t in targets]
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers or max(1, len(self.conns)))

    def sweep(self) -> List[HostSample]:
        return list(self._pool.map(
            lambda c: c.sample(self._timeout_s), self.conns))

    def close(self) -> None:
        # a raising pool shutdown must not leak the per-host
        # connections (each c.close() is itself best-effort)
        try:
            self._pool.shutdown(wait=True)
        finally:
            for c in self.conns:
                c.close()


def _fmt(v, suffix="", width=0, nd=0) -> str:
    if v is None:
        return "-".rjust(width)
    text = f"{v:.{nd}f}{suffix}" if isinstance(v, float) else f"{v}{suffix}"
    return text.rjust(width)


def render(samples: List[HostSample]) -> str:
    rows = []
    header = (f"{'host':<28} {'chips':>5} {'pwr W':>8} {'maxT':>5} "
              f"{'tc%':>6} {'hbm%':>6} {'hbm used/total MiB':>22} "
              f"{'links':>5} {'events':>6}")
    rows.append(header)
    rows.append("-" * len(header))
    up = [s for s in samples if s.up]
    for s in samples:
        if not s.up:
            rows.append(f"{s.address:<28} {'DOWN':>5}  ({s.error[:60]})")
            continue
        rows.append(
            f"{s.address:<28} {s.chips:>5} {s.power_w:>8.1f} "
            f"{_fmt(s.max_temp_c, width=5)} "
            f"{_fmt(s.mean_tc_util, width=6, nd=1)} "
            f"{_fmt(s.mean_hbm_util, width=6, nd=1)} "
            f"{s.hbm_used_mib:>11}/{s.hbm_total_mib:<10} "
            f"{s.links_up:>5} {s.events:>6}")
    rows.append("-" * len(header))
    total_chips = sum(s.chips for s in up)
    tc = [s.mean_tc_util for s in up if s.mean_tc_util is not None]
    hb = [s.mean_hbm_util for s in up if s.mean_hbm_util is not None]
    temps = [s.max_temp_c for s in up if s.max_temp_c is not None]
    rows.append(
        f"{'SLICE (' + str(len(up)) + '/' + str(len(samples)) + ' up)':<28} "
        f"{total_chips:>5} {sum(s.power_w for s in up):>8.1f} "
        f"{_fmt(max(temps) if temps else None, width=5)} "
        f"{_fmt(sum(tc) / len(tc) if tc else None, width=6, nd=1)} "
        f"{_fmt(sum(hb) / len(hb) if hb else None, width=6, nd=1)} "
        f"{sum(s.hbm_used_mib for s in up):>11}/"
        f"{sum(s.hbm_total_mib for s in up):<10} "
        f"{sum(s.links_up for s in up):>5} "
        f"{sum(s.events for s in up):>6}")
    return "\n".join(rows)


def check_render(samples: List[HostSample],
                 expect_chips: Optional[int]) -> "tuple[str, bool]":
    """Slice-readiness gate: PASS/FAIL per host + overall verdict.

    A host passes when it is reachable, serves >=1 chip (== the
    expected count when given), and EVERY chip's bulk sweep returned at
    least one live value (a single dead chip in an 8-chip host must not
    be masked by the others).  The operator use: gate a training launch
    on `tpumon-fleet --check ... && launch`.
    """

    rows = []
    ok = True
    for s in samples:
        if not s.up:
            rows.append(f"{s.address:<28} [FAIL] unreachable: "
                        f"{s.error[:70]}")
            ok = False
            continue
        problems = []
        if s.chips < 1:
            problems.append("no chips")
        if expect_chips is not None and s.chips != expect_chips:
            problems.append(f"{s.chips} chips, expected {expect_chips}")
        if s.dead_chips:
            problems.append(f"{s.dead_chips} chip(s) returned no values")
        if problems:
            rows.append(f"{s.address:<28} [FAIL] {'; '.join(problems)}")
            ok = False
        else:
            rows.append(f"{s.address:<28} [PASS] {s.chips} chips, "
                        f"{s.live_fields} live values, {s.driver}")
    up = sum(1 for s in samples if s.up)
    rows.append(f"---- {len(samples)} host(s): {up} up, "
                f"{'READY' if ok else 'NOT READY'}")
    return "\n".join(rows), ok


def read_targets_file(path: str) -> List[str]:
    """Parse a targets file: one agent address per line, ``#`` starts
    a comment, blank lines ignored — a 4096-entry fleet cannot live on
    argv.  Raises ``OSError`` on an unreadable file."""

    targets = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                targets.append(line)
    return targets


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="tpumon-fleet", description=__doc__)
    p.add_argument("targets", nargs="*", metavar="ADDR",
                   help="agent address: unix:/path or host:port")
    p.add_argument("--connect", action="append", default=[],
                   metavar="ADDR", help="agent address (repeatable): "
                   "unix:/path or host:port")
    p.add_argument("--targets-file", default=None,
                   help="file with one agent address per line "
                        "(# comments); exclusive with positional/"
                        "--connect targets — a fleet has ONE source "
                        "of truth")
    p.add_argument("-d", "--delay", type=float, default=2.0,
                   help="seconds between sweeps")
    p.add_argument("-c", "--count", type=int, default=None,
                   help="number of sweeps (default: forever)")
    p.add_argument("--timeout", type=float, default=3.0,
                   help="per-host sweep deadline seconds")
    p.add_argument("--backoff-base", type=float, default=None,
                   metavar="S",
                   help="reconnect backoff floor for failed hosts "
                        "(default 0.5; supervised children tune this "
                        "to the tick cadence)")
    p.add_argument("--backoff-max", type=float, default=None,
                   metavar="S",
                   help="reconnect backoff ceiling (default 30)")
    p.add_argument("--once", action="store_true", help="one sweep and exit")
    p.add_argument("--check", action="store_true",
                   help="slice-readiness gate: one sweep, PASS/FAIL per "
                        "host, exit 1 unless every host passes "
                        "(gate a launch on `tpumon-fleet --check ... &&`)")
    p.add_argument("--expect-chips", type=int, default=None, metavar="N",
                   help="with --check: require exactly N chips per host")
    p.add_argument("--blackbox-dir", default=None, metavar="DIR",
                   help="flight recorder: tee every host's decoded "
                        "sweeps (plus piggybacked events) into per-host "
                        "segment directories under DIR; replay with "
                        "tpumon-replay --host (docs/blackbox.md)")
    p.add_argument("--blackbox-max-bytes", type=int, default=None,
                   metavar="N",
                   help="flight recorder disk budget per HOST in bytes "
                        "(default 64 MiB)")
    p.add_argument("--stream-port", type=int, default=0, metavar="N",
                   help="live streaming subscription plane: re-publish "
                        "every host's decoded sweeps as one stream per "
                        "host (stream name == target address) on this "
                        "TCP port (0 disables; subscribe with "
                        "tpumon-stream --stream ADDR — "
                        "docs/streaming.md)")
    p.add_argument("--shards", type=int, default=0, metavar="N",
                   help="hierarchical fleet: hash-partition the "
                        "targets over N in-process poller shards, each "
                        "re-served as an agent-compatible endpoint, "
                        "consumed by one top-level poller (0 = flat; "
                        "docs/incremental_pipeline.md)")
    p.add_argument("--shard-serve", type=int, default=0, metavar="PORT",
                   help="run ONE fleet shard standalone: sweep the "
                        "given targets and re-serve the aggregate as "
                        "synthetic chip rows on this TCP port (a "
                        "top-level tpumon-fleet consumes it with the "
                        "ordinary agent protocol)")
    p.add_argument("--shard-serve-unix", default=None, metavar="PATH",
                   help="like --shard-serve, on a unix socket — the "
                        "form the --supervise children run (a stale "
                        "socket file at PATH is replaced)")
    p.add_argument("--shard-id", type=int, default=0, metavar="N",
                   help="with --shard-serve[-unix]: this shard's id "
                        "in the hello/self-metric labels")
    p.add_argument("--supervise", action="store_true",
                   help="with --shards: run each shard as a "
                        "SUPERVISED CHILD PROCESS (spawn, "
                        "health-watch, jittered-backoff restart under "
                        "a restart budget; docs/operations.md) "
                        "instead of in-process threads")
    p.add_argument("--restart-budget", type=int, default=5, metavar="N",
                   help="with --supervise: restarts allowed per shard "
                        "per minute before it is parked (circuit "
                        "breaker; default 5)")
    p.add_argument("--metrics-port", type=int, default=0, metavar="N",
                   help="serve tpumon_fleet_shard_* self-metrics "
                        "(promtext) on this port — requires --shards "
                        "or --shard-serve[-unix]")
    p.add_argument("--rules", default=None, metavar="FILE",
                   help="streaming anomaly detection over per-host "
                        "CHIP values (rules.yaml, docs/anomaly.md): "
                        "one engine per host rides the poller — in a "
                        "shard tree the shards score and re-serve "
                        "findings upstream as piggybacked events; "
                        "findings print as '!' lines and land in the "
                        "--blackbox-dir recording as 0xB3 records")
    p.add_argument("--fleet-rules", default=None, metavar="FILE",
                   help="with --shards: anomaly rules over the "
                        "synthetic HOST ROWS (SF_* fields) the "
                        "top-level poller consumes — the fleet-view "
                        "rule set")
    args = p.parse_args(argv)
    if args.expect_chips is not None and not args.check:
        # a gate invocation missing --check would exit 0 unconditionally
        p.error("--expect-chips requires --check")
    if args.shard_serve and args.shard_serve_unix:
        p.error("--shard-serve and --shard-serve-unix are exclusive "
                "(one listener per serving shard)")
    serve_one = bool(args.shard_serve or args.shard_serve_unix)
    if args.shards and serve_one:
        p.error("--shards and --shard-serve[-unix] are exclusive (a "
                "process is either the tree or one leaf of it)")
    if serve_one and args.check:
        p.error("--check needs the full fleet view, not a serving "
                "shard")
    if args.supervise and not args.shards:
        p.error("--supervise requires --shards")
    if args.supervise and args.check:
        p.error("--check is a one-shot gate; run it against a flat "
                "or in-process fleet view")
    if args.metrics_port and not (args.shards or serve_one):
        p.error("--metrics-port requires --shards or "
                "--shard-serve[-unix]")
    if args.fleet_rules and not args.shards:
        p.error("--fleet-rules requires --shards (it scores the "
                "synthetic rows the top-level poller consumes)")
    if (args.rules or args.fleet_rules) and args.supervise:
        p.error("--rules under --supervise is not wired yet: pass "
                "--rules to the shard children via --shard-serve-unix "
                "invocations instead")

    targets = list(args.targets) + list(args.connect)
    if args.targets_file:
        if targets:
            # a fleet must have exactly one source of truth: silently
            # merging a 4096-line file with stray argv targets hides
            # whichever one the operator forgot about
            p.error("--targets-file cannot be combined with "
                    "positional/--connect targets")
        try:
            targets = read_targets_file(args.targets_file)
        except OSError as e:
            die(str(e))
    if not targets:
        die("no targets (use --connect, positional targets or "
            "--targets-file)")

    count = 1 if args.once else args.count

    def body() -> int:
        from ..fleetshard import FleetShard, ShardedFleet, \
            shard_metric_lines
        rules = None
        fleet_rules = None
        if args.rules or args.fleet_rules:
            from ..anomaly import load_rules
            try:
                if args.rules:
                    rules = load_rules(args.rules)
                if args.fleet_rules:
                    fleet_rules = load_rules(args.fleet_rules)
            except (OSError, ValueError) as e:
                die(str(e))
        backoff_kwargs: Dict[str, float] = {}
        if args.backoff_base is not None:
            backoff_kwargs["backoff_base_s"] = args.backoff_base
        if args.backoff_max is not None:
            backoff_kwargs["backoff_max_s"] = args.backoff_max
        stream_server = None
        stream_hub = None
        if args.stream_port:
            from ..frameserver import FrameServer, StreamHub
            stream_server = FrameServer()
            stream_hub = StreamHub(stream_server)
            addr = stream_server.add_tcp_listener(
                stream_hub, host="", port=args.stream_port)
            stream_server.start()
            print(f"# streaming per-host sweeps on {addr} "
                  f"(tpumon-stream --connect HOST:{args.stream_port} "
                  f"--stream <target-address>)", file=sys.stderr,
                  flush=True)

        shard = None
        sharded = None
        supervisor = None
        poller = None
        shard_server = None
        metrics_server = None
        if args.shard_serve or args.shard_serve_unix:
            from ..frameserver import FrameServer
            shard_server = FrameServer()
            shard = FleetShard(args.shard_id, targets, _FIELDS,
                               timeout_s=args.timeout,
                               blackbox_dir=args.blackbox_dir,
                               blackbox_max_bytes=args.blackbox_max_bytes,
                               stream_hub=stream_hub, rules=rules,
                               **backoff_kwargs)
            if args.shard_serve_unix:
                # a dead predecessor (SIGKILL leaves no cleanup)
                # leaves its socket file behind; the replacement must
                # bind the same path — that is the supervised restart
                # contract (re-admission = the top poller reconnects)
                try:
                    os.unlink(args.shard_serve_unix)
                except OSError:
                    pass
                addr = shard.serve_on(shard_server,
                                      path=args.shard_serve_unix)
                consume = addr
            else:
                addr = shard.serve_on(shard_server,
                                      tcp_port=args.shard_serve)
                consume = f"HOST:{args.shard_serve}"
            shard_server.start()
            shard.start()
            print(f"# serving shard aggregate on {addr} "
                  f"(consume with tpumon-fleet --connect "
                  f"{consume})", file=sys.stderr,
                  flush=True)
            def sweep() -> List[HostSample]:
                samples = shard.tick(args.timeout * 2.0)
                if not shard.last_tick_fresh:
                    # a frozen table during an incident is the exact
                    # failure mode this tool exists to avoid — say it
                    print("# WARNING: shard tick timed out; table "
                          "shows the LAST completed sweep",
                          file=sys.stderr, flush=True)
                return samples
        elif args.shards and args.supervise:
            from ..supervisor import ShardSupervisor
            top_bb = (None if args.blackbox_dir is None else
                      os.path.join(args.blackbox_dir, "_shards"))
            supervisor = ShardSupervisor(
                targets, _FIELDS, shards=args.shards,
                delay_s=args.delay, timeout_s=args.timeout,
                restart_budget=args.restart_budget,
                blackbox_dir=args.blackbox_dir,
                blackbox_max_bytes=args.blackbox_max_bytes,
                top_blackbox_dir=top_bb,
                top_stream_hub=stream_hub,
                poller_backoff_base_s=args.backoff_base,
                poller_backoff_max_s=args.backoff_max)
            supervisor.start()
            print(f"# supervising {args.shards} shard child "
                  f"processes (run dir {supervisor.run_dir})",
                  file=sys.stderr, flush=True)
            sweep = supervisor.poll
        elif args.shards:
            # tees at BOTH levels: per-host recording/streams live in
            # the shards (same layout and names as a flat poller);
            # the shard-aggregate tier records under _shards/ and
            # streams under the shard endpoints' addresses
            top_bb = (None if args.blackbox_dir is None else
                      os.path.join(args.blackbox_dir, "_shards"))
            sharded = ShardedFleet(
                targets, _FIELDS, shards=args.shards,
                timeout_s=args.timeout,
                blackbox_dir=args.blackbox_dir,
                blackbox_max_bytes=args.blackbox_max_bytes,
                stream_hub=stream_hub,
                top_blackbox_dir=top_bb,
                top_stream_hub=stream_hub, rules=rules,
                top_rules=fleet_rules, **backoff_kwargs)
            sweep = sharded.poll
        else:
            # one event loop for the whole fleet: persistent
            # connections, hello once per connection, delta sweeps —
            # driven by the native epoll engine when it is built
            poller = create_fleet_poller(
                targets, _FIELDS, timeout_s=args.timeout,
                blackbox_dir=args.blackbox_dir,
                blackbox_max_bytes=args.blackbox_max_bytes,
                stream_hub=stream_hub, rules=rules, **backoff_kwargs)
            sweep = poller.poll
        if args.metrics_port:
            from ..httputil import TextHTTPServer

            def metrics_dispatch(path: str) -> Tuple[int, str, str]:
                if path != "/metrics":
                    return 404, "text/plain", "not found\n"
                if supervisor is not None:
                    # the merged surface: child tick stats (from their
                    # hellos) + supervision state per shard
                    from ..supervisor import supervisor_metric_lines
                    lines = supervisor_metric_lines(
                        supervisor.shard_stats())
                else:
                    stats = (sharded.shard_stats()
                             if sharded is not None
                             else [shard.stats()])
                    lines = shard_metric_lines(stats)
                text = "\n".join(lines) + "\n"
                return 200, "text/plain; version=0.0.4", text

            metrics_server = TextHTTPServer(metrics_dispatch,
                                            args.metrics_port)
            metrics_server.start()
            print(f"# shard self-metrics on port "
                  f"{metrics_server.port}/metrics", file=sys.stderr,
                  flush=True)
        try:
            if args.check:
                text, ok = check_render(sweep(), args.expect_chips)
                print(text, flush=True)
                return 0 if ok else 1
            for tick in ticker(args.delay, count):
                if tick > 0:
                    print()
                print(render(sweep()), flush=True)
                findings_src = (poller if poller is not None
                                else sharded if sharded is not None
                                else shard)
                if findings_src is not None and (rules is not None
                                                 or fleet_rules
                                                 is not None):
                    from .replay import render_finding_line
                    for addr, rec in findings_src.take_findings():
                        # '!' lines between tables: the operator sees
                        # the verdict the moment it fires, in the ONE
                        # timeline-line shape replay/--follow/stream
                        # share, with the host spliced in
                        line = render_finding_line(rec)
                        print(f"! host={addr} {line[2:]}", flush=True)
        finally:
            if poller is not None:
                poller.close()
            if sharded is not None:
                sharded.close()
            if supervisor is not None:
                supervisor.close()
            if shard is not None:
                shard.close()
            if shard_server is not None:
                shard_server.close()
            if metrics_server is not None:
                metrics_server.stop()
            if stream_server is not None:
                stream_server.close()
        return 0

    return epipe_safe(body)


if __name__ == "__main__":
    sys.exit(main())
