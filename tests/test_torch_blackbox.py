"""The port's flight recorder and replay CLI against the reference's.

``tpumon_torch.blackbox`` and ``tpumon_torch.cli.replay`` are copies of
``tpumon.blackbox`` and ``tpumon.cli.replay`` with imports renamed.  Both
writers, given the same inputs and the same sweep stamps, must write
identical segment files under identical names (rotation, retention and
restart included); each reader must read the other's files into the same
items; torn tails must be recovered alike; and the replay CLI's
``--list``, ``table``, ``json``, ``promtext``, ``--follow`` and
``--backtest`` output must equal the reference CLI's on the same
directory.  Inputs are seeded with numpy; tolerance: exact.
"""

import os

import numpy as np
import pytest

from tpumon import blackbox as JBB
from tpumon import events as JEV
from tpumon.cli import replay as JR
from tpumon_torch import anomaly as TA
from tpumon_torch import blackbox as TBB
from tpumon_torch import events as TEV
from tpumon_torch.cli import replay as TR

T0 = 1_790_000_000.0
FIDS = (155, 156, 203, 204, 150, 2620, 2621, 2622, 2623, 52)
RULES = """version: 1
detectors:
  - name: hot
    field: TENSORCORE_UTIL
    type: threshold
    above: 80
  - name: power_jump
    field: POWER_USAGE
    type: rate_of_change
    max_rise: 150
  - name: stuck_energy
    field: TOTAL_ENERGY
    type: flatline
    for_s: 3
incidents:
  - name: hot_and_xid
    require:
      - anomaly: hot
      - kmsg: "Xid"
    window_s: 10
"""


def _sweeps(seed, n=30):
    rng = np.random.default_rng(seed)
    vals = {c: {f: None for f in FIDS} for c in range(2)}
    out = []
    for k in range(n):
        for c in vals:
            v = vals[c]
            v[155] = float(round(rng.uniform(60, 700), 3))
            if rng.random() < 0.7:
                v[156] = int(1e9 + k * 500 * (c + 1))
            v[203] = int(rng.choice([0, 5, 90, 100]))
            v[204] = int(rng.integers(0, 100)) if rng.random() < 0.5 \
                else v[204]
            v[150] = int(rng.integers(30, 80))
            v[52] = f"GPU-{c}"
            for a in range(4):
                v[2620 + a] = (float(rng.uniform(0, 700))
                               if rng.random() < 0.8 else None)
        snap = {c: dict(v) for c, v in vals.items()
                if not (c == 1 and 10 <= k < 13)}  # chip 1 lost a while
        out.append((T0 + k, snap))
    return out


def _events(mod, k):
    if k % 7 != 3:
        return None
    return [mod.Event(etype=mod.EventType.CHIP_RESET, timestamp=T0 + k + 0.2,
                      seq=k, chip_index=k % 2, uuid=f"GPU-{k % 2}",
                      message=f"Xid 79 at {k}")]


def _finding(mod, k):
    return mod.AnomalyRecord(timestamp=T0 + k, kind="anomaly", rule="hot",
                             severity="warning", state="firing", chip=k % 2,
                             field=203, value=90.0, score=None,
                             message="tcutil=90 above 80")


def _record(mod, evmod, d, seed, **kw):
    w = mod.BlackBoxWriter(str(d), host="node-a", **kw)
    for k, (ts, snap) in enumerate(_sweeps(seed)):
        if k % 5 == 2:
            w.record_kmsg(f"NVRM: Xid (PCI:0000:3b:00): 79, sweep {k}",
                          now=ts - 0.25)
        w.record_sweep(snap, events=_events(evmod, k), now=ts)
        if k % 9 == 8:  # the same sweep again, known unchanged
            w.record_sweep(snap, now=ts + 0.5, unchanged=True)
        if k % 6 == 5:
            w.record_finding(_finding(mod, k))
    w.close()
    return w


def _files(d):
    return {n: (d / n).read_bytes() for n in sorted(os.listdir(d))}


def _norm(item):
    """A replayed item as plain data, whichever module made it."""

    name = type(item).__name__
    if name == "ReplayTick":
        return (name, item.timestamp, item.snapshot, item.keyframe,
                item.changes, item.stale,
                [(int(e.etype), e.seq, e.chip_index, e.timestamp, e.uuid,
                  e.message) for e in item.events])
    return (name,) + tuple(vars(item).values()) if name == "KmsgRecord" \
        else (name, repr(item).split("(", 1)[1])


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("kw", [{}, {"max_segment_bytes": 700},
                                {"max_segment_bytes": 600, "max_bytes": 2000}],
                         ids=["one-segment", "rotation", "retention"])
def test_writers_write_identical_segments(tmp_path, seed, kw):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref = _record(JBB, JEV, tmp_path / "ref", seed, **kw)
    port = _record(TBB, TEV, tmp_path / "port", seed, **kw)
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    assert port.stats() == ref.stats()
    if "max_bytes" in kw:
        assert port.stats()["segments_reclaimed_total"] > 0


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_each_reader_reads_the_others_segments(tmp_path, writer):
    mod, evmod = {"ref": (JBB, JEV), "port": (TBB, TEV)}[writer]
    _record(mod, evmod, tmp_path, 1, max_segment_bytes=900)
    readers = (JBB.BlackBoxReader(str(tmp_path)),
               TBB.BlackBoxReader(str(tmp_path)))
    seg = [[(s.name, s.start_ts, s.size, s.host, s.version)
            for s in r.segments()] for r in readers]
    assert seg[0] == seg[1] and len(seg[0]) > 1
    for window in ((None, None), (T0 + 7.5, None), (T0 + 3, T0 + 20.1),
                   (T0 + 40, None)):
        items = [[_norm(x) for x in r.replay(*window)] for r in readers]
        assert items[0] == items[1]
        assert readers[0].last_records == readers[1].last_records
    kinds = {x[0] for x in items[0]} if items[0] else set()
    full = [_norm(x) for x in readers[1].replay()]
    assert {x[0] for x in full} == {"ReplayTick", "KmsgRecord",
                                    "AnomalyRecord"} and kinds <= \
        {x[0] for x in full}


def test_torn_tails_are_recovered_alike(tmp_path):
    _record(JBB, JEV, tmp_path, 2)
    (name,) = os.listdir(tmp_path)
    data = (tmp_path / name).read_bytes()
    rng = np.random.default_rng(0)
    cuts = sorted(set(int(c) for c in rng.integers(1, len(data), 40)))
    for cut in cuts + [len(data) - 1]:
        (tmp_path / name).write_bytes(data[:cut])
        got = []
        for mod in (JBB, TBB):
            r = mod.BlackBoxReader(str(tmp_path))
            got.append(([_norm(x) for x in r.replay()],
                        r.last_torn_segments, r.last_records))
        assert got[0] == got[1]
    # garbage after whole records: recovered up to it, never raised
    (tmp_path / name).write_bytes(data + b"\xb1\x05garb")
    got = [[_norm(x) for x in mod.BlackBoxReader(str(tmp_path)).replay()]
           for mod in (JBB, TBB)]
    assert got[0] == got[1]


def test_a_restarted_writer_opens_a_new_segment(tmp_path):
    for side, mod in (("ref", JBB), ("port", TBB)):
        d = tmp_path / side
        for k in range(2):
            w = mod.BlackBoxWriter(str(d), host="h")
            w.record_sweep({0: {155: 100.0 + k}}, now=T0)
            w.close()
    assert _files(tmp_path / "ref") == _files(tmp_path / "port")
    assert len(_files(tmp_path / "port")) == 2


def test_findings_encode_to_the_reference_bytes():
    rng = np.random.default_rng(3)
    for k in range(40):
        kw = dict(timestamp=T0 + float(rng.random()),
                  kind=str(rng.choice(["anomaly", "incident"])),
                  rule=f"r{k}", severity=str(rng.choice(
                      ["info", "warning", "critical", "bogus"])),
                  state=str(rng.choice(["firing", "cleared"])),
                  chip=int(rng.integers(-1, 4)),
                  field=int(rng.integers(-1, 300)),
                  value=None if k % 3 else float(rng.normal()),
                  score=None if k % 4 else float(rng.normal()),
                  message="" if k % 5 == 0 else f"msg {k} µ",
                  evidence=tuple(f"anomaly:r@{k}#chip{j}"
                                 for j in range(k % 3)))
        assert TBB.encode_finding(TBB.AnomalyRecord(**kw)) == \
            JBB.encode_finding(JBB.AnomalyRecord(**kw))


# ---- the replay CLI -------------------------------------------------------------

def _both(capsys, argv):
    out = []
    for main in (JR.main, TR.main):
        rc = main(argv)
        cap = capsys.readouterr()
        out.append((rc, cap.out, cap.err))
    return out


@pytest.fixture
def recording(tmp_path):
    d = tmp_path / "bb"
    d.mkdir()
    _record(TBB, TEV, d, 4, max_segment_bytes=1500)
    rules = tmp_path / "rules.yaml"
    rules.write_text(RULES)
    return str(d), str(rules)


@pytest.mark.parametrize("args", [
    ["--list"], [], ["--format", "json"], ["--format", "promtext"],
    ["--at", str(T0 + 12.5)], ["--format", "promtext", "--at", str(T0 + 4)],
    ["--since", str(T0 + 5), "--until", str(T0 + 17), "--format", "json"],
    ["--until", str(T0 + 9)],
    ["--follow", "--since", "0", "--count", "4", "--format", "json"],
    ["--follow", "--since", str(T0 + 20), "--count", "3"],
], ids=["list", "table", "json", "promtext", "at", "promtext-at", "window",
        "until", "follow-json", "follow-table"])
def test_replay_cli_equals_the_reference(capsys, recording, args):
    d, _ = recording
    ref, port = _both(capsys, ["--dir", d, *args])
    assert port == ref and ref[0] == 0 and ref[1]


@pytest.mark.parametrize("fmt", ["table", "json"])
def test_backtest_equals_the_reference(capsys, recording, fmt):
    d, rules = recording
    ref, port = _both(capsys, ["--dir", d, "--backtest", rules,
                               "--format", fmt])
    assert port == ref and ref[0] == 0
    assert "hot_and_xid" in ref[1] and "stuck_energy" in ref[1]


def test_backtest_names_the_card_with_the_bus_map(capsys, tmp_path):
    """With ``--bus`` the backtest's engine classifies the recorded Xid
    line to the card, as the live engine given the same bus map did."""

    d = tmp_path / "bb"
    rules = tmp_path / "rules.yaml"
    rules.write_text("version: 1\ndetectors:\n  - name: hot\n"
                     "    field: TENSORCORE_UTIL\n    type: threshold\n"
                     "    above: 80\nincidents:\n  - name: lost\n"
                     "    require:\n      - anomaly: hot\n"
                     "      - event: CHIP_RESET\n    window_s: 10\n")
    buses = {(0, 0x3B, 0): 0}
    live = TA.AnomalyEngine(TA.load_rules(str(rules)), buses)
    w = TBB.BlackBoxWriter(str(d), host="h")
    line = "NVRM: Xid (PCI:0000:3b:00): 79, pid=1, GPU has fallen off the bus."
    found = []
    for k in range(4):  # as the exporter's sweep records them
        recs = []
        if k == 2:
            w.record_kmsg(line, now=T0 + k - 0.5)
            recs += live.observe_kmsg(line, T0 + k - 0.5)
        snap = {0: {203: 95 if k else 10}}
        recs += live.observe(snap, now=T0 + k)
        w.record_sweep(snap, now=T0 + k)
        for r in recs:
            w.record_finding(r)
        found += recs
    w.close()
    assert any("#chip0" in e for r in found for e in r.evidence)
    rc = TR.main(["--dir", str(d), "--backtest", str(rules), "--format",
                  "json", "--bus", "0000:3b:00=0"])
    lines = capsys.readouterr().out.splitlines()
    rc2 = TR.main(["--dir", str(d), "--format", "json"])
    recorded = [ln for ln in capsys.readouterr().out.splitlines()
                if '"kind": "anomaly"' in ln or '"kind": "incident"' in ln]
    assert rc == rc2 == 0 and lines[:-1] == recorded
    assert "#chip0" in "".join(recorded)
    # without the map, the Xid names no card: the evidence differs
    TR.main(["--dir", str(d), "--backtest", str(rules), "--format", "json"])
    assert capsys.readouterr().out.splitlines()[:-1] != recorded
    with pytest.raises(SystemExit):
        TR.main(["--dir", str(d), "--format", "json", "--bus", "x=0"])


def test_replay_cli_refusals_equal_the_reference(capsys, tmp_path):
    for argv in (["--dir", str(tmp_path / "none")],
                 ["--dir", str(tmp_path), "--follow", "--list"],
                 ["--dir", str(tmp_path), "--count", "2"]):
        codes = []
        for main in (JR.main, TR.main):
            with pytest.raises(SystemExit) as e:
                main(argv)
            codes.append((e.value.code, capsys.readouterr().err
                           .replace("tpumon_torch", "tpumon")))
        assert codes[0][0] == codes[1][0] != 0
