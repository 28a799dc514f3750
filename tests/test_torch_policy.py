"""The port's policy engine and event sets (``tpumon_torch.policy``,
``tpumon_torch.event_set``) against the JAX package's, and over the fake
NVML.

The scripted backend of ``test_torch_health`` serves both packages the
same seeded field values and events.  Both ``PolicyManager``s must give
the same violation sequence, threshold-sourced (edge-triggered, re-armed
below the threshold) and event-sourced alike, called directly and through
the façade's watch pump; both ``EventSet``s the same events.  Over the
fake NVML an injected Xid 79 gives one CHIP_RESET violation and one
``EventSet.wait`` hit, and the policy CLI prints one POWER violation for
a breach that lasts.
"""

import os
import queue
import subprocess
import sys

import pytest

import tpumon
import tpumon_torch
from tpumon import events as JEV
from tpumon.event_set import EventSet as JaxEventSet
from tpumon.policy import PolicyManager as JaxPolicy
from tpumon_torch import events as TEV
from tpumon_torch.event_set import CRITICAL_EVENTS, EventSet
from tpumon_torch.policy import PolicyManager

from test_torch_health import EVENTS, F, STEPS, T0, pair, script_frames
from test_torch_nvml import _build, _controls, wait_for

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def clock():
    return T0


def drain(q):
    out = []
    while True:
        try:
            v = q.get_nowait()
        except queue.Empty:
            return out
        out.append((v.condition.name, v.timestamp, v.chip_index,
                    dict(v.data), v.message))


#: (chip, conditions by name, thresholds by name) registrations
REGISTRATIONS = [
    (0, ["ALL"], None),
    (2, ["THERMAL", "POWER"], {"THERMAL": 60, "POWER": 400}),
    (-1, ["CHIP_RESET", "ECC_DBE", "PCIE"], None),
]


def register(pm, ev, chip, conds, thresholds):
    c = ev.PolicyCondition.NONE
    for name in conds:
        c |= ev.PolicyCondition[name]
    th = ({ev.PolicyCondition[k]: v for k, v in thresholds.items()}
          if thresholds else None)
    return pm.register(chip, c, th)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_violation_sequences_equal_the_reference(seed):
    b, jb = pair(seed)
    ours, ref = PolicyManager(b, clock=clock), JaxPolicy(jb, clock=clock)
    qs = [register(ours, TEV, *r) for r in REGISTRATIONS]
    jqs = [register(ref, JEV, *r) for r in REGISTRATIONS]
    got, want, emitted = [], [], []
    for step in range(1, STEPS):
        seen = b.current_event_seq()
        b.advance()
        jb.advance()
        for e in b.poll_events(seen):
            ours.on_event(e)
        for e in jb.poll_events(seen):
            ref.on_event(e)
        emitted.append([(v.condition.name, v.chip_index)
                        for v in ours.evaluate(now=T0 + step)])
        assert [(v.condition.name, v.chip_index)
                for v in ref.evaluate(now=T0 + step)] == emitted[-1]
        got.append([drain(q) for q in qs])
        want.append([drain(q) for q in jqs])
    assert got == want
    # one publisher: every subscriber of a manager sees one sequence
    assert all(g[0] == g[1] == g[2] for g in got)
    # edge trigger: a threshold fires on the step its reading crosses the
    # limit, and again only after a step below it re-armed it
    frames = script_frames(seed)
    for chip, conds, th in REGISTRATIONS[:2]:
        limits = {"THERMAL": 100, "POWER": 250, "HBM_REMAP": 10}
        limits.update(th or {})
        fids = {"THERMAL": int(F.CORE_TEMP), "POWER": int(F.POWER_USAGE),
                "HBM_REMAP": int(F.HBM_REMAPPED_DBE)}
        for cond, fid in fids.items():
            if conds != ["ALL"] and cond not in conds:
                continue
            armed, want_steps = True, []
            for step in range(1, STEPS):
                v = frames[step][chip].get(fid)
                if v is None:
                    continue
                if v >= limits[cond] and armed:
                    armed = False
                    want_steps.append(step)
                elif v < limits[cond]:
                    armed = True
            got_steps = [k + 1 for k, em in enumerate(emitted)
                         if (cond, chip) in em]
            assert got_steps == want_steps, (cond, chip)
    kinds = {v[0] for steps in got for v in steps[0]}
    assert {"THERMAL", "POWER", "ECC_DBE", "CHIP_RESET", "PCIE"} <= kinds


def test_facade_policy_through_the_watch_pump():
    """``Handle.register_policy``: the watch sweep's listeners evaluate
    the thresholds and pump the backend's events, as in the reference."""

    b, jb = pair(7)
    h, jh = tpumon_torch.Handle(b, clock=clock), tpumon.Handle(jb,
                                                             clock=clock)
    q = register(h.policy, TEV, *REGISTRATIONS[0])
    jq = register(jh.policy, JEV, *REGISTRATIONS[0])
    got, want = [], []
    for _ in range(1, STEPS):
        b.advance()
        jb.advance()
        h.watches.update_all(wait=True)
        jh.watches.update_all(wait=True)
        got.append(drain(q))
        want.append(drain(jq))
    assert got == want
    assert sum(len(g) for g in got) >= 3
    assert h.register_policy(1, TEV.PolicyCondition.THERMAL).empty()


def event_rows(es):
    out = []
    while True:
        ev = es.wait(0)
        if ev is None:
            return out
        out.append((ev.etype.name, ev.chip_index, ev.seq, ev.message))


@pytest.mark.parametrize("chip", [-1, 0, 1, 2])
def test_event_sets_equal_the_reference(chip):
    b, jb = pair()
    h, jh = tpumon_torch.Handle(b, clock=clock), tpumon.Handle(jb,
                                                             clock=clock)
    crit, jcrit = h.new_event_set(), jh.new_event_set()
    crit.register_event(chip_index=chip)
    jcrit.register_event(chip_index=chip)
    every, jevery = EventSet(h.watches), JaxEventSet(jh.watches)
    every.register_event(list(TEV.EventType), chip_index=chip)
    jevery.register_event(list(JEV.EventType), chip_index=chip)
    got, want = [], []
    for _ in range(1, STEPS):
        b.advance()
        jb.advance()
        h.watches.update_all(wait=True)
        jh.watches.update_all(wait=True)
        got.append((event_rows(crit), event_rows(every)))
        want.append((event_rows(jcrit), event_rows(jevery)))
    assert got == want
    # the critical set: chip 1's Xid 79 and the host's runtime restart
    assert [r[0] for g in got for r in g[0]] == {
        -1: ["CHIP_RESET", "RUNTIME_RESTART"], 1: ["CHIP_RESET"]}.get(chip, [])
    every_count = sum(len(g[1]) for g in got)
    assert every_count == sum(1 for evs in EVENTS.values() for c, _, _ in evs
                              if chip == -1 or c == chip)
    crit.close()
    every.close()
    with EventSet(h.watches) as quiet:
        quiet.register_event()
        h.watches.update_all(wait=True)
        assert quiet.wait(0.01) is None
    assert len(h.watches._event_listeners) == 1  # the policy manager's


# ---- over the fake NVML --------------------------------------------------------

@pytest.fixture(scope="module")
def fake_lib(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("nvml_policy"), "libfake_nvml.so")


@pytest.fixture
def fake(fake_lib, tmp_path, monkeypatch):
    from tpumon_torch.backends import nvml as N

    monkeypatch.setattr(N.NvmlBackend, "EVENT_WAIT_MS", 20)
    monkeypatch.setenv("TPUMON_NVML_PATH", fake_lib)
    monkeypatch.setenv("TPUMON_KMSG_PATH", str(tmp_path / "no-kmsg"))
    monkeypatch.delenv("TPUMON_BACKEND", raising=False)
    return _controls(fake_lib)


def test_xid_79_over_nvml_is_one_violation_and_one_event(fake):
    h = tpumon_torch.init()
    try:
        q = h.register_policy(0, TEV.PolicyCondition.CHIP_RESET)
        es = h.new_event_set()
        es.register_event(CRITICAL_EVENTS, chip_index=0)
        h.watches.update_all(wait=True)
        assert es.wait(0.01) is None and q.empty()  # quiet
        fake.fake_nvml_inject_xid(0, 79)
        fake.fake_nvml_inject_xid(1, 79)  # another card's: not chip 0's
        assert wait_for(lambda: len(h.backend.poll_events(0)) == 2)
        for _ in range(3):
            h.watches.update_all(wait=True)
        ev = es.wait(1.0)
        assert (ev.etype.name, ev.chip_index, ev.message) == \
            ("CHIP_RESET", 0, "Xid 79")
        assert es.wait(0.01) is None
        v = q.get(timeout=1.0)
        assert (v.condition.name, v.chip_index, v.message) == \
            ("CHIP_RESET", 0, "Xid 79")
        assert q.empty()
        es.close()
    finally:
        tpumon_torch.shutdown()


@pytest.fixture
def cli_env(fake_lib, tmp_path):
    env = dict(os.environ, TPUMON_NVML_PATH=fake_lib,
               TPUMON_KMSG_PATH=str(tmp_path / "no-kmsg"), PYTHONPATH=REPO)
    env.pop("TPUMON_BACKEND", None)
    return env


def _cli(module, *args, env):
    return subprocess.run([sys.executable, "-m", f"tpumon_torch.cli.{module}",
                           *args], capture_output=True, text=True,
                          timeout=120, cwd=REPO, env=env)


def test_policy_cli_over_nvml_fires_once_per_breach(cli_env):
    """The fake's card 0 draws a steady 123.456 W: a 100 W limit is one
    breach that lasts, so one line; thermal (41 C) stays under 100 C."""

    r = _cli("policy", "--conditions", "power,thermal", "--power-limit",
             "100", "--duration", "1.2", env=cli_env)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert lines[0] == ("Listening for policy violations on chip 0 "
                        "(power,thermal)...")
    assert [ln.split(" ", 1)[1] for ln in lines[1:]] == [
        "chip 0 POWER: POWER threshold breached: 123.456 >= 100.0"]
    bad = _cli("policy", "--conditions", "nope", env=cli_env)
    assert bad.returncode == 1 and "unknown condition" in bad.stderr
    gone = _cli("policy", "--chip", "7", "--duration", "0.1", env=cli_env)
    assert gone.returncode == 2 and "no such chip: 7" in gone.stderr


def test_health_cli_over_nvml(cli_env):
    r = _cli("health", "--chip", "1", env=cli_env)
    assert (r.returncode, r.stdout) == (0, "Chip 1 overall health: PASS\n")
    r = _cli("health", env=cli_env)
    assert r.returncode == 1  # card 0's VBIOS is the minority's: WARN
    assert r.stdout.splitlines()[0] == "Chip 0 overall health: WARN"
    assert r.stdout.splitlines()[1].startswith("  [WARN] FIRMWARE: firmware ")
    bad = _cli("health", "--chip", "4", env=cli_env)
    assert bad.returncode == 2 and "no such chip: 4" in bad.stderr
