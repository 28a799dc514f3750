"""The port's anomaly plane against the reference's.

``tpumon_torch.anomaly`` is a copy of ``tpumon.anomaly`` (and
``tpumon_torch.simple_yaml`` of the YAML-subset loader in
``tpumon/chaos.py``) with imports renamed.  The same rules files must
parse to the same rules, refuse the same mistakes with the same message,
and the same seeded sweep streams must give equal ``AnomalyRecord``
sequences and counters from both engines — threshold, EWMA z-score, rate
of change (per second and absolute), flatline, and incidents joining
anomalies, events and kmsg substrings; so must a backtest of one
recording.  What the port changes: kernel-log lines are classified by its
``NVRM: Xid`` table with the engine's GPU bus map, so an Xid line names
the card (``#chip<i>``).  Inputs are seeded with numpy; tolerance:
exact.
"""

import glob
import os

import numpy as np
import pytest

from tpumon import anomaly as JA
from tpumon import blackbox as JBB
from tpumon import events as JEV
from tpumon.chaos import parse_simple_yaml as j_yaml
from tpumon_torch import anomaly as TA
from tpumon_torch import blackbox as TBB
from tpumon_torch import events as TEV
from tpumon_torch.simple_yaml import parse_simple_yaml as t_yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = 1_790_000_000.0

RULES = {
    "version": 1,
    "detectors": [
        {"name": "hot", "field": "TENSORCORE_UTIL", "type": "threshold",
         "above": 80, "severity": "critical"},
        {"name": "cold", "field": "tpu_core_temp", "type": "threshold",
         "below": 35},
        {"name": "power_z", "field": 155, "type": "ewma_z", "z": 2.5,
         "alpha": 0.2, "min_samples": 4},
        {"name": "hbm_rate", "field": "hbmbw", "type": "rate_of_change",
         "max_rise_per_s": 30, "max_drop_per_s": 40},
        {"name": "power_step", "field": "POWER_USAGE",
         "type": "rate_of_change", "max_rise": 200, "max_drop": 250},
        {"name": "energy_stuck", "field": "TOTAL_ENERGY", "type": "flatline",
         "for_s": 3, "severity": "info"},
    ],
    "incidents": [
        {"name": "hot_xid", "require": [{"anomaly": "hot"},
                                        {"kmsg": "Xid"}], "window_s": 4},
        {"name": "hot_reset", "require": [{"anomaly": "hot"},
                                          {"event": "CHIP_RESET"}],
         "window_s": 6, "cooldown_s": 2},
        {"name": "step_and_z", "require": [{"anomaly": "power_step"},
                                           {"anomaly": "power_z"}],
         "window_s": 3},
    ],
}


def _stream(seed, n=60):
    rng = np.random.default_rng(seed)
    energy = [10**9, 2 * 10**9]
    out = []
    for k in range(n):
        snap = {}
        for c in range(2):
            if c == 1 and 20 <= k < 23:
                continue
            if rng.random() < 0.6:
                energy[c] += int(rng.integers(1, 5000))
            util = rng.choice([0, 12, 85, 100, None, "n/a", float("nan")])
            snap[c] = {
                203: util.item() if hasattr(util, "item") else util,
                150: int(rng.integers(25, 80)),
                155: float(rng.uniform(60, 700)) if k % 11 else 1500.0,
                204: int(rng.integers(0, 100)),
                156: energy[c],
            }
        ts = T0 + k + (0.5 if k % 13 == 0 else 0.0)
        # lines neither classifier takes: they join by substring only
        kmsg = [f"pcieport: note {k}"]
        if k % 9 == 4:
            kmsg.append(f"driver: Xid report {k}")
        out.append((ts, snap, k % 10 == 7, kmsg))
    return out


def _events(mod, k):
    if k % 8 != 5:
        return None
    return [mod.Event(etype=mod.EventType.CHIP_RESET, timestamp=T0 + k,
                      seq=k, chip_index=k % 2, message="reset")]


def _recs(recs):
    return [tuple(vars(r).values()) for r in recs]


def test_yaml_loader_equals_the_reference():
    texts = [open(p).read() for p in sorted(glob.glob(
        os.path.join(REPO, "tests", "data", "*", "*.yaml")))]
    texts += ["a: [1, 2.5, x]\nb:\n  - c: 'q # not a comment'\n    d: ~\n",
              "- 1\n-\n  - 2\n", "k: v # note\nt: true\nf: False\n",
              "a: 1\n\tb: 2\n", "a: 1\n  - x\n", "- a\nb: 1\n",
              "x:\n  - 1\n y: 2\n"]
    assert len(texts) > 8
    errors = 0
    for text in texts:
        got = []
        for fn in (j_yaml, t_yaml):
            try:
                got.append(fn(text))
            except ValueError as e:
                got.append(f"ValueError: {e}")
        assert got[0] == got[1]
        errors += str(got[0]).startswith("ValueError")
    assert errors >= 2


def test_rules_load_equal_to_the_reference(tmp_path):
    text = (
        "version: 1\ndetectors:\n"
        "  - name: hot\n    field: TENSORCORE_UTIL\n    type: threshold\n"
        "    above: 80\n"
        "  - name: z\n    field: tpu_power_usage\n    type: ewma_z\n"
        "    z: 3\n    alpha: 0.25\nincidents:\n"
        "  - name: inc\n    window_s: 5\n    require:\n"
        "      - anomaly: hot\n      - kmsg: Xid\n")
    path = tmp_path / "r.yaml"
    path.write_text(text)
    a, b = JA.load_rules(str(path)), TA.load_rules(str(path))
    assert [vars(r) for r in a.detectors] == [vars(r) for r in b.detectors]
    assert [vars(r) for r in a.incidents] == [vars(r) for r in b.incidents]
    assert a.version == b.version == 1


@pytest.mark.parametrize("patch", [
    {"version": 2}, {"detectors": [], "incidents": []}, {"extra": 1},
    {"detectors": [{"name": "x", "field": 203, "type": "spike"}]},
    {"detectors": [{"name": "x", "field": 203, "type": "threshold"}]},
    {"detectors": [{"name": "x", "field": 203, "type": "threshold",
                    "above": 1, "sevrity": "info"}]},
    {"detectors": [{"name": "x", "field": "NOPE", "type": "threshold",
                    "above": 1}]},
    {"detectors": [{"name": "x", "field": 203, "type": "ewma_z",
                    "alpha": 1.0}]},
    {"detectors": [{"name": "x", "field": 203, "type": "flatline",
                    "for_s": 0}]},
    {"detectors": [{"name": "x", "field": 203, "type": "rate_of_change"}]},
    {"detectors": [{"name": "x", "field": 203, "type": "threshold",
                    "above": 1}] * 2},
    {"incidents": [{"name": "i", "require": [{"anomaly": "nope"}]}]},
    {"incidents": [{"name": "i", "require": [{"event": "NOPE"}]}]},
    {"incidents": [{"name": "i", "require": [{"kmsg": "x"}],
                    "cooldown_s": -1}]},
    {"incidents": [{"name": "i", "require": []}]},
], ids=[f"mistake{k}" for k in range(15)])
def test_rule_mistakes_are_refused_alike(patch):
    data = dict(RULES, **patch)
    errs = []
    for mod in (JA, TA):
        with pytest.raises(ValueError) as e:
            mod.Rules.from_dict(data)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("seed", range(6))
def test_engines_emit_equal_findings(seed):
    engines = (JA.AnomalyEngine(JA.Rules.from_dict(RULES)),
               TA.AnomalyEngine(TA.Rules.from_dict(RULES)))
    got = ([], [])
    for k, (ts, snap, unchanged, kmsg) in enumerate(_stream(seed)):
        for side, (eng, evmod) in enumerate(zip(engines, (JEV, TEV))):
            out = []
            for j, line in enumerate(kmsg):
                out += eng.observe_kmsg(line, ts - 0.1 * (j + 1))
            out += eng.observe(snap, now=ts, events=_events(evmod, k),
                               unchanged=unchanged)
            got[side].append(_recs(out))
        assert engines[0].stats() == engines[1].stats()
    assert got[0] == got[1]
    flat = [r for sweep in got[1] for r in sweep]
    kinds = {(r[1], r[2]) for r in flat}
    assert ("anomaly", "hot") in kinds and ("anomaly", "power_z") in kinds
    assert ("anomaly", "energy_stuck") in kinds
    assert ("incident", "hot_xid") in kinds and ("incident", "hot_reset") in kinds


def test_unchanged_ticks_score_nothing():
    for mod in (JA, TA):
        eng = mod.AnomalyEngine(mod.Rules.from_dict(RULES))
        eng.observe({0: {203: 90, 155: 100.0}}, now=T0)
        assert eng.last_scored > 0
        eng.observe({0: {203: 90, 155: 100.0}}, now=T0 + 1)
        assert eng.last_scored == 0
        eng.observe({0: {203: 10}}, now=T0 + 2, unchanged=True)
        assert eng.last_scored == 0


def test_xid_lines_name_the_card_through_the_bus_map():
    """The port's classifier: an ``NVRM: Xid`` line of a mapped code joins
    an incident with its card named through the engine's bus map; an
    unmapped bus names no card; an unmapped code is no evidence."""

    rules = TA.Rules.from_dict(
        {"version": 1,
         "detectors": [{"name": "hot", "field": 203, "type": "threshold",
                        "above": 80}],
         "incidents": [{"name": "lost", "window_s": 5,
                        "require": [{"anomaly": "hot"},
                                    {"event": "CHIP_RESET"}]},
                       {"name": "ecc", "window_s": 5,
                        "require": [{"event": "ECC_DBE"}]}]})
    buses = {(0, 0x3B, 0): 0, (0, 0x86, 0): 1}
    eng = TA.AnomalyEngine(rules, buses)
    eng.observe({1: {203: 95}}, now=T0)
    out = eng.observe_kmsg("NVRM: Xid (PCI:0000:86:00): 79, pid=9, GPU has "
                           "fallen off the bus.", T0 + 1)
    assert [r.rule for r in out] == ["lost"]
    assert out[0].evidence == ("anomaly:hot@1790000000.000#chip1",
                               "event:CHIP_RESET@1790000001.000#chip1")
    out = eng.observe_kmsg("NVRM: Xid (PCI:0000:3b:00): 48, pid=9, DBE",
                           T0 + 2)
    assert [(r.rule, r.evidence) for r in out] == [
        ("ecc", ("event:ECC_DBE@1790000002.000#chip0",))]
    assert eng.observe_kmsg("NVRM: Xid (PCI:0000:3b:00): 13, Graphics",
                            T0 + 3) == []
    bare = TA.AnomalyEngine(rules)  # no bus map: no card named
    assert bare.observe_kmsg("NVRM: Xid (PCI:0000:3b:00): 48, DBE",
                             T0)[0].evidence == ("event:ECC_DBE@1790000000.000",)


def test_fleet_shard_fields_are_not_known():
    """Once a divergence (the port had no fleet plane), now the
    reference's behaviour: the fleet shard's synthetic ``SF_*`` fields
    resolve and display through ``tpumon_torch.fleetshard``, and a name
    in that range the shard does not define stays unknown in both."""

    for name in ("SF_UP", "SF_ADDRESS", "SF_ERROR"):
        assert TA.resolve_field(name) == JA.resolve_field(name)
    assert TA.resolve_field("SF_UP") == 9001
    assert TA.field_name(9001) == JA.field_name(9001) == "SF_UP"
    assert TA.field_name(9099) == JA.field_name(9099) == "9099"
    with pytest.raises(ValueError, match="unknown field 'SF_NOPE'"):
        TA.resolve_field("SF_NOPE")
    with pytest.raises(ValueError, match="unknown field 'SF_NOPE'"):
        JA.resolve_field("SF_NOPE")
    for spec in (203, "203", "0xcb", "TENSORCORE_UTIL", "tcutil",
                 "tpu_tensorcore_utilization"):
        assert TA.resolve_field(spec) == JA.resolve_field(spec) == 203
        assert TA.field_name(203) == JA.field_name(203)


@pytest.mark.parametrize("seed", range(3))
def test_backtest_equals_the_reference(tmp_path, seed):
    w = TBB.BlackBoxWriter(str(tmp_path), host="h", max_segment_bytes=900)
    for k, (ts, snap, _, kmsg) in enumerate(_stream(seed, 40)):
        for line in kmsg:
            w.record_kmsg(line, now=ts - 0.2)
        w.record_sweep(snap, events=_events(TEV, k), now=ts)
    w.close()
    results = [mod.backtest(bb.BlackBoxReader(str(tmp_path)),
                            mod.Rules.from_dict(RULES), since, until)
               for mod, bb in ((JA, JBB), (TA, TBB))
               for since, until in ((None, None), (T0 + 5, T0 + 30))]
    ref, port = results[:2], results[2:]
    for a, b in zip(ref, port):
        assert _recs(a.verdicts) == _recs(b.verdicts)
        assert a.summary() == b.summary()
        assert a.ticks == b.ticks and a.kmsg_lines == b.kmsg_lines
    assert port[0].verdicts


def test_metric_families_equal_the_reference():
    assert TA.METRIC_FAMILIES == JA.METRIC_FAMILIES
    assert TA.DETECTOR_TYPES == JA.DETECTOR_TYPES
