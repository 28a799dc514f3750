"""tpumon-replay — reconstruct recorded sweep history from a black box.

The port's copy of ``tpumon/cli/replay.py``.  The flight recorder
(:mod:`tpumon_torch.blackbox`; the exporter daemon's ``--blackbox-dir``)
tees every sweep's delta frame into bounded on-disk segments; this tool
replays a time window back out::

    python -m tpumon_torch.cli.replay --dir /var/lib/tpumon/blackbox \
        --since -3600

Windows: ``--since`` / ``--until`` take unix seconds, or negative
values meaning "seconds before now" (``--since -3600`` = the last
hour).  Output formats:

* ``table`` (default) — the reconstructed per-chip snapshot at the end
  of the window (or ``--at TS``), one row per chip, one column per
  recorded field (catalog short names where known).
* ``promtext`` — the same snapshot rendered as a Prometheus exposition
  via the exporter's renderer (catalog fields only), e.g. to diff a
  recorded moment against a live scrape.
* ``json`` — the full event timeline: one JSON object per line for
  every tick (timestamp, changed-entry count, chip count, keyframe),
  every piggybacked event, every recorded kmsg line and finding.

``--list`` prints the segment inventory instead (name, start time,
size, host); ``--follow`` tails a live recording; ``--backtest RULES``
re-derives the anomaly plane's verdicts from the recorded window
(``--bus BUS=INDEX``: the live engine's GPU bus map, so kernel-log
evidence names the card as it did live).  A recorder directory with one
subdirectory per host is addressed with ``--host``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence

from .. import fields as FF
from ..backends.base import FieldValue
from ..blackbox import (AnomalyRecord, BlackBoxReader, KmsgRecord,
                        ReplayTick)
from ..kmsg import BusKey, bus_key
from .common import die, epipe_safe


def _resolve_ts(raw: Optional[str], now: float) -> Optional[float]:
    if raw is None:
        return None
    try:
        v = float(raw)
    except ValueError:
        die(f"bad timestamp {raw!r} (unix seconds, or negative = "
            f"seconds before now)")
    return now + v if v < 0 else v


def _field_name(fid: int) -> str:
    meta = FF.CATALOG.get(fid)
    return meta.name if meta is not None else str(fid)


def _fmt_value(v: FieldValue) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.3f}".rstrip("0").rstrip(".")
    if isinstance(v, list):
        return "[" + ",".join(_fmt_value(e) for e in v) + "]"
    return str(v)


def render_table(snapshot: Dict[int, Dict[int, FieldValue]],
                 timestamp: Optional[float]) -> str:
    """One row per chip, one column per recorded field.

    Burst-derived fields (``fields.burst_id``) collapse into ONE
    column per source field — header ``<name>~1s``, cell
    ``min/max/mean/integral`` — instead of four full-width columns
    per source; the column sits right after the source field's own.
    The JSON line shape (:func:`_item_objs`) is untouched — grouping
    is a table-rendering concern only."""

    if not snapshot:
        return "(no recorded ticks in the window)"
    all_fids = sorted({f for vals in snapshot.values() for f in vals})
    #: source fid -> {agg: derived fid} for the recorded burst fields
    burst: Dict[int, Dict[int, int]] = {}
    plain: List[int] = []
    for f in all_fids:
        src = FF.burst_source(f)
        if src is not None:
            burst.setdefault(src[0], {})[src[1]] = f
        else:
            plain.append(f)

    # column list: (sort key, header, cell renderer).  A burst group
    # keys at source + 0.5 so it lands right after its base column
    # (or where the base would sort, when the base was not recorded).
    def _plain_cell(fid: int) -> "Callable[[Dict[int, FieldValue]], str]":
        return lambda vals: _fmt_value(vals.get(fid))

    def _burst_cell(aggs: Dict[int, int]
                    ) -> "Callable[[Dict[int, FieldValue]], str]":
        def cell(vals: Dict[int, FieldValue]) -> str:
            return "/".join(
                _fmt_value(vals.get(aggs[a])) if a in aggs else "-"
                for a in range(len(FF.BURST_AGGS)))
        return cell

    columns = [(float(f), _field_name(f), _plain_cell(f))
               for f in plain]
    columns += [(s + 0.5, f"{_field_name(s)}~1s", _burst_cell(aggs))
                for s, aggs in burst.items()]
    columns.sort(key=lambda c: c[0])
    names = [c[1] for c in columns]
    chips = sorted(snapshot)
    # render every cell first: widths must cover the CELLS too (a
    # burst group cell joins four values and is routinely wider than
    # its header — header-only widths would misalign everything after)
    matrix = [[cell(snapshot[chip]) for _, _, cell in columns]
              for chip in chips]
    widths = [max(len(n), 6, *(len(row[i]) for row in matrix))
              if matrix else max(len(n), 6)
              for i, n in enumerate(names)]
    rows: List[str] = []
    if timestamp is not None:
        rows.append(f"# snapshot at {timestamp:.3f} "
                    f"({time.strftime('%Y-%m-%d %H:%M:%S', time.localtime(timestamp))})")
    rows.append("chip  " + "  ".join(
        n.rjust(w) for n, w in zip(names, widths)))
    for chip, row in zip(chips, matrix):
        rows.append(f"{chip:<4}  " + "  ".join(
            c.rjust(w) for c, w in zip(row, widths)))
    return "\n".join(rows)


def render_promtext(snapshot: Dict[int, Dict[int, FieldValue]]) -> str:
    """The snapshot as a Prometheus exposition (catalog fields only —
    a recorded stream may carry field ids the catalog never named)."""

    from ..exporter.promtext import SweepRenderer

    fids = sorted({f for vals in snapshot.values() for f in vals
                   if f in FF.CATALOG})
    renderer = SweepRenderer(fids)
    labels = {c: {"chip": str(c)} for c in snapshot}
    return renderer.render(snapshot, labels)


def _item_objs(item: object) -> Iterator[Dict[str, object]]:
    """The one definition of the JSON line shape — windowed replay,
    ``--follow`` and ``tpumon-stream`` all emit through it."""

    if isinstance(item, ReplayTick):
        obj: Dict[str, object] = {
            "kind": "tick", "ts": item.timestamp,
            "chips": len(item.snapshot),
            "changes": item.changes,
            "keyframe": item.keyframe}
        if item.stale:
            # a relay's last-known state, not a fresh sweep — absent
            # on fresh ticks so the steady JSON shape is unchanged
            obj["stale"] = True
        yield obj
        for e in item.events:
            yield {"kind": "event", "ts": e.timestamp,
                   "etype": int(e.etype), "etype_name": e.etype.name,
                   "seq": e.seq, "chip": e.chip_index,
                   "uuid": e.uuid, "message": e.message}
    elif isinstance(item, KmsgRecord):
        yield {"kind": "kmsg", "ts": item.timestamp,
               "line": item.line}
    elif isinstance(item, AnomalyRecord):
        from ..anomaly import field_name as _afield
        yield {"kind": item.kind, "ts": item.timestamp,
               "rule": item.rule, "severity": item.severity,
               "state": item.state, "chip": item.chip,
               "field": item.field,
               "field_name": (_afield(item.field)
                              if item.field >= 0 else ""),
               "value": item.value, "score": item.score,
               "message": item.message,
               "evidence": list(item.evidence)}


def _json_items(reader: BlackBoxReader, since: Optional[float],
                until: Optional[float]
                ) -> Iterator[Dict[str, object]]:
    for item in reader.replay(since, until):
        yield from _item_objs(item)


def render_finding_line(rec: AnomalyRecord) -> str:
    """One human timeline line per detection-plane verdict (table
    format — like the JSON shape, shared by replay, --follow and
    tpumon-stream)."""

    from ..anomaly import field_name as _afield

    where = f" chip={rec.chip}" if rec.chip >= 0 else ""
    what = f" {_afield(rec.field)}" if rec.field >= 0 else ""
    ev = (" [" + "; ".join(rec.evidence) + "]") if rec.evidence else ""
    return (f"! {rec.timestamp:.3f} {rec.severity} {rec.kind} "
            f"{rec.rule} ({rec.state}){where}{what}: "
            f"{rec.message}{ev}")


def _emit_item(item: object, fmt: str) -> None:
    if fmt == "json":
        for obj in _item_objs(item):
            print(json.dumps(obj, sort_keys=True), flush=True)
    elif isinstance(item, AnomalyRecord):
        # the table timeline surfaces verdicts inline, like events in
        # the JSON shape (promtext has no place for them)
        if fmt == "table":
            print(render_finding_line(item), flush=True)
    elif isinstance(item, ReplayTick):
        if fmt == "promtext":
            sys.stdout.write(render_promtext(item.snapshot))
            sys.stdout.write("\n")
            sys.stdout.flush()
        else:
            if item.stale:
                print(f"# STALE: relay upstream down; last-known "
                      f"state as of {item.timestamp:.3f}", flush=True)
            print(render_table(item.snapshot, item.timestamp),
                  flush=True)
            print(flush=True)


#: --follow: how far (seconds) a recorded kernel line's event stamp
#: may lag the newest emitted tick and still be emitted.  Bounds the
#: per-poll re-scan window — kmsg stamps are not monotone vs tick
#: stamps, but the skew is small; lines older than this are dropped.
_FOLLOW_KMSG_SLACK_S = 5.0


def _follow(reader: BlackBoxReader, since: Optional[float], fmt: str,
            count: Optional[int], poll_interval: float) -> int:
    """Tail the recording: re-replay the window after the last emitted
    tick at ``poll_interval`` cadence.  Segments are self-contained
    and the reader tolerates the live segment's torn tail, so each
    poll is an ordinary windowed replay — ticks already emitted are
    skipped by timestamp (tick timestamps are monotone per writer)."""

    # wall clock: the recorder stamps wall time, and "from now on" is
    # a wall-time notion for the operator tailing the box
    last = since if since is not None \
        else time.time()  # tpumon-lint: disable=wallclock-in-sampling
    # kmsg cursor: (timestamp, lines already emitted AT that stamp) —
    # kernel-event stamps may repeat within a printk burst, so a bare
    # timestamp cursor would silently drop equal-stamped lines
    last_kmsg = last
    kmsg_at_cursor = 0
    first_pass = since is not None
    ticks = 0
    while True:
        # window from the OLDER cursor: kmsg stamps (kernel event time)
        # are not monotone vs tick stamps, so a tick-only window would
        # silently drop a kernel line stamped just before the last tick
        # — the per-kind guards below dedup the re-scanned items.
        # Retention may reclaim the tailed segment between polls (tiny
        # byte budgets make it routine): the reader skips reclaimed
        # files and this loop re-opens whatever is newest, so the
        # follower rides THROUGH reclamation — it never raises and
        # never anchors on a file that no longer exists, it just
        # under-delivers the ticks retention deleted.
        cursor_ts, skip_eq, seen_eq = last_kmsg, kmsg_at_cursor, 0
        for item in reader.replay(min(last, last_kmsg)):
            ts = item.timestamp
            if isinstance(item, ReplayTick):
                if not first_pass and ts <= last:
                    continue
                _emit_item(item, fmt)
                last = max(last, ts)
                ticks += 1
                if count is not None and ticks >= count:
                    return 0
            else:  # KmsgRecord (stamps monotone per writer thread)
                if not first_pass:
                    if ts < last_kmsg:
                        continue
                    if ts == cursor_ts:
                        # re-scanned lines at the pass-start cursor:
                        # skip exactly the ones already emitted, keep
                        # any NEW equal-stamped lines appended since
                        seen_eq += 1
                        if seen_eq <= skip_eq:
                            continue
                _emit_item(item, fmt)
                if ts > last_kmsg:
                    last_kmsg = ts
                    kmsg_at_cursor = 1
                elif ts == last_kmsg:
                    kmsg_at_cursor += 1
        first_pass = False
        # keep the kmsg cursor within the slack of the tick cursor:
        # with no kmsg traffic it would otherwise anchor the window at
        # follow start and re-decode an ever-growing history each poll
        floor = last - _FOLLOW_KMSG_SLACK_S
        if floor > last_kmsg:
            last_kmsg = floor
            kmsg_at_cursor = 0
        time.sleep(poll_interval)


def _backtest(reader: BlackBoxReader, rules_path: str,
              since: Optional[float], until: Optional[float],
              fmt: str, buses: Optional[Dict[BusKey, int]] = None) -> int:
    """Replay the window through a fresh engine and report the
    verdicts: fired findings/incidents with timestamps and evidence,
    cooldown-suppressed firings, and the rules that stayed silent.
    ``json`` emits one object per verdict (the ``_item_objs`` shape)
    plus a final ``backtest_summary`` object."""

    from ..anomaly import backtest, load_rules

    try:
        rules = load_rules(rules_path)
    except (OSError, ValueError) as e:
        die(str(e))
    result = backtest(reader, rules, since, until, buses)
    summary = result.summary()
    if fmt == "json":
        for rec in result.verdicts:
            for obj in _item_objs(rec):
                print(json.dumps(obj, sort_keys=True))
        print(json.dumps({"kind": "backtest_summary", **summary},
                         sort_keys=True))
    else:
        for rec in result.verdicts:
            print(render_finding_line(rec))
        print(f"--- backtest over {summary['ticks']} tick(s), "
              f"{summary['kmsg_lines']} kmsg line(s): "
              f"{summary['verdicts']} verdict(s)")
        for rule, n in sorted(summary["fired"].items()):
            print(f"    fired     {rule}: {n}")
        for rule, n in sorted(summary["incidents"].items()):
            print(f"    incident  {rule}: {n}")
        for rule, n in sorted(summary["suppressed"].items()):
            print(f"    suppressed {rule}: {n} (cooldown)")
        for rule in summary["silent_rules"]:
            print(f"    silent    {rule}")
    if reader.last_torn_segments:
        print(f"# {reader.last_torn_segments} segment(s) had a "
              f"torn/garbage tail (verdicts cover the recovered "
              f"prefix)", file=sys.stderr)
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="tpumon-replay", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dir", required=True,
                   help="flight recorder directory (segment files)")
    p.add_argument("--host", default=None, metavar="SUB",
                   help="host subdirectory (fleet recorder layout)")
    p.add_argument("--since", default=None, metavar="TS",
                   help="window start: unix seconds, or negative = "
                        "seconds before now")
    p.add_argument("--until", default=None, metavar="TS",
                   help="window end (same forms)")
    p.add_argument("--at", default=None, metavar="TS",
                   help="table/promtext: snapshot at/just before TS "
                        "(default: end of window)")
    p.add_argument("--format", choices=("table", "promtext", "json"),
                   default="table", help="output format (default table)")
    p.add_argument("--list", action="store_true",
                   help="list segments instead of replaying")
    p.add_argument("--backtest", default=None, metavar="RULES",
                   help="replay the window through the SAME streaming "
                        "AnomalyEngine live detection runs, loaded "
                        "with this rules.yaml, and report every "
                        "verdict it fires (and the rules that stayed "
                        "silent or were cooldown-suppressed) — "
                        "validate a rule change against last night's "
                        "recorded incident before it ships "
                        "(docs/anomaly.md)")
    p.add_argument("--bus", action="append", default=[],
                   metavar="BUS=INDEX",
                   help="with --backtest: one entry of the live "
                        "engine's GPU bus map (PCI bus id = the index "
                        "its backend served, e.g. 0000:3b:00=0; "
                        "repeatable), so kernel-log evidence names the "
                        "card as it did live")
    p.add_argument("--follow", action="store_true",
                   help="tail the live recording: keep emitting ticks "
                        "as the writer appends them (the file-based "
                        "twin of tpumon-stream; the reader already "
                        "tolerates the live segment's torn tail, so "
                        "following is a re-poll of the newest ticks)")
    p.add_argument("--count", type=int, default=None, metavar="N",
                   help="with --follow: exit after N ticks (default: "
                        "follow forever)")
    p.add_argument("--poll-interval", type=float, default=0.5,
                   metavar="S",
                   help="with --follow: re-poll cadence in seconds "
                        "(default 0.5)")
    args = p.parse_args(argv)
    if args.follow and (args.list or args.at is not None
                        or args.until is not None):
        p.error("--follow is incompatible with --list/--at/--until")
    if args.count is not None and not args.follow:
        p.error("--count requires --follow")
    if args.backtest and (args.follow or args.list
                          or args.at is not None):
        p.error("--backtest is incompatible with --follow/--list/--at")
    if args.bus and not args.backtest:
        p.error("--bus requires --backtest")
    buses: Dict[BusKey, int] = {}
    for entry in args.bus:
        bus, sep, idx = entry.rpartition("=")
        key = bus_key(bus)
        if not sep or key is None or not idx.isdigit():
            p.error(f"--bus {entry!r}: expected PCI-BUS-ID=INDEX")
        buses[key] = int(idx)

    directory = args.dir
    if args.host:
        directory = os.path.join(directory, args.host)
    if not os.path.isdir(directory):
        hosts = []
        if os.path.isdir(args.dir):
            hosts = sorted(n for n in os.listdir(args.dir)
                           if os.path.isdir(os.path.join(args.dir, n)))
        hint = f" (hosts: {', '.join(hosts)})" if hosts else ""
        die(f"no such recorder directory: {directory}{hint}")

    # wall clock on purpose: the recorder stamps wall time, and the
    # window the operator asks for is a wall-time window
    now = time.time()  # tpumon-lint: disable=wallclock-in-sampling
    since = _resolve_ts(args.since, now)
    until = _resolve_ts(args.until, now)
    at = _resolve_ts(args.at, now)
    reader = BlackBoxReader(directory)

    def body() -> int:
        if args.backtest:
            return _backtest(reader, args.backtest, since, until,
                             args.format, buses)
        if args.follow:
            return _follow(reader, since, args.format, args.count,
                           args.poll_interval)
        if args.list:
            segs = reader.segments()
            for s in segs:
                print(f"{s.name}  start={s.start_ts:.3f}  "
                      f"{s.size:>10d}B  v{s.version}  host={s.host}")
            print(f"{len(segs)} segment(s)")
            return 0
        if args.format == "json":
            for obj in _json_items(reader, since, until):
                print(json.dumps(obj, sort_keys=True))
            if reader.last_torn_segments:
                print(json.dumps({"kind": "torn_segments",
                                  "count": reader.last_torn_segments}),
                      file=sys.stderr)
            return 0
        # table / promtext: the LAST snapshot at/before the target time.
        # Segments are self-contained (each starts with a keyframe), so
        # without an explicit --since the scan starts at the last
        # segment covering the target instead of decoding the whole
        # recorded history for one snapshot.
        end = at if at is not None else until
        scan_since = since
        if scan_since is None:
            covering = [s for s in reader.segments()
                        if end is None or s.start_ts <= end]
            if covering:
                scan_since = covering[-1].start_ts
        snapshot: Dict[int, Dict[int, FieldValue]] = {}
        ts: Optional[float] = None
        findings: List[AnomalyRecord] = []
        for item in reader.replay(scan_since, end):
            if isinstance(item, ReplayTick):
                snapshot, ts = item.snapshot, item.timestamp
            elif isinstance(item, AnomalyRecord):
                findings.append(item)
        if args.format == "promtext":
            sys.stdout.write(render_promtext(snapshot))
        else:
            print(render_table(snapshot, ts))
            # the detection plane's verdicts inside the scanned
            # window, listed under the snapshot (timeline '!' lines,
            # same shape --follow and tpumon-stream emit)
            for rec in findings:
                print(render_finding_line(rec))
        if reader.last_torn_segments:
            # stderr on every format: a silently truncated recording
            # must never read as a complete one
            print(f"# {reader.last_torn_segments} segment(s) had a "
                  f"torn/garbage tail (recovered up to the tear)",
                  file=sys.stderr)
        return 0

    return epipe_safe(body)


if __name__ == "__main__":
    sys.exit(main())
