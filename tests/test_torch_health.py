"""The port's health watch (``tpumon_torch.health``) against the JAX
package's, and over the fake NVML.

A scripted backend, defined here once and built twice (over each
package's ``Backend``, ``ChipInfo`` and ``Event``), serves the same
seeded sequence of field values and events to both packages' monitors:
numpy draws the background (temperatures, power, slowly rising
counters) from the seed, and a fixed script lays the cases over it —
the thermal warn band and fail, an SBE storm, a DBE, pending remaps, a
PCIe replay delta, NVLink CRC errors and a link down, power over the
card's limit beside a rising power-violation counter, firmware skew
across the three chips, blanks (one chip answers its PCIe and NVLink
counters NOT_SUPPORTED throughout, as NVML does on a host that hides
them), and the baseline taken at set.  Every check's status and incidents must be equal
exactly.  Over the fake NVML (``tpumon_torch/testlib/fake_nvml.c``) an
injected Xid 79 must give RUNTIME FAIL, and refused PCIe/NVLink counters
no incident.
"""

import numpy as np
import pytest

import tpumon
import tpumon_torch
from tpumon import events as JEV
from tpumon import fields as JF
from tpumon import types as JT
from tpumon.backends.base import Backend as JaxBackend
from tpumon.health import HealthMonitor as JaxHealth
from tpumon_torch import events as TEV
from tpumon_torch import types as TT
from tpumon_torch.backends.base import Backend
from tpumon_torch.health import HealthMonitor

F = JF.F
T0 = 1_900_000_000.0
CHIPS = 3
STEPS = 14
#: the card's power limit (W) every scripted chip reports
LIMIT_W = 700.0
#: chip 2 runs a VBIOS the other two do not
FIRMWARE = ("96.00.74.00.01", "96.00.74.00.01", "96.00.99.00.02")
#: the chip whose PCIe and NVLink counters are blank throughout
BLANK_CHIP = 1
BLANK_FIELDS = (int(F.PCIE_REPLAY_COUNTER), int(F.ICI_CRC_ERRORS),
                int(F.ICI_REPLAY_ERRORS), int(F.ICI_RECOVERY_ERRORS),
                int(F.ICI_LINKS_UP))
COUNTERS = (int(F.ECC_DBE_VOLATILE), int(F.ECC_SBE_VOLATILE),
            int(F.HBM_REMAPPED_DBE), int(F.ICI_CRC_ERRORS),
            int(F.ICI_REPLAY_ERRORS), int(F.ICI_RECOVERY_ERRORS),
            int(F.PCIE_REPLAY_COUNTER), int(F.THERMAL_VIOLATION),
            int(F.POWER_VIOLATION))
#: step -> [(chip, {field: value or ("+", delta)})]: the cases
SCRIPT = {
    2: [(0, {int(F.CORE_TEMP): 93})],
    3: [(0, {int(F.CORE_TEMP): 101})],
    4: [(0, {int(F.ECC_SBE_VOLATILE): ("+", 150)})],
    5: [(0, {int(F.ECC_DBE_VOLATILE): ("+", 1)})],
    6: [(0, {int(F.HBM_REMAP_PENDING): 2})],
    7: [(0, {int(F.PCIE_REPLAY_COUNTER): ("+", 3)})],
    8: [(0, {int(F.ICI_CRC_ERRORS): ("+", 5)}),
        (2, {int(F.ICI_LINKS_UP): 16})],
    9: [(0, {int(F.POWER_USAGE): 712.5,
             int(F.POWER_VIOLATION): ("+", 1000)})],
    10: [(0, {f: None for f in (int(F.CORE_TEMP), int(F.POWER_USAGE),
                                int(F.PCIE_REPLAY_COUNTER),
                                int(F.ICI_CRC_ERRORS))})],
}
#: step -> [(chip, event type name, message)]
EVENTS = {
    5: [(0, "ECC_DBE", "Xid 48")],
    8: [(2, "ICI_ERROR", "Xid 74")],
    11: [(1, "CHIP_RESET", "Xid 79"), (-1, "RUNTIME_RESTART", "")],
    12: [(0, "PCIE_ERROR", "pcieport 0000:17:01.0: AER: Corrected error")],
}


def script_frames(seed: int):
    """Per step, each chip's field values: the seeded background with
    the script laid over it (counters are cumulative, so a scripted
    delta carries into every later step)."""

    rng = np.random.RandomState(seed)
    level = {c: {f: int(rng.randint(1, 4)) for f in COUNTERS}
             for c in range(CHIPS)}
    frames = []
    for step in range(STEPS):
        frame = {}
        for c in range(CHIPS):
            for f in COUNTERS:
                if f not in (int(F.ECC_DBE_VOLATILE),
                             int(F.PCIE_REPLAY_COUNTER)) and \
                        f not in range(int(F.ICI_CRC_ERRORS),
                                       int(F.ICI_RECOVERY_ERRORS) + 1):
                    level[c][f] += int(rng.randint(0, 3))
            vals = {
                int(F.CORE_TEMP): int(rng.randint(35, 80)),
                int(F.HBM_TEMP): int(rng.randint(35, 80)),
                int(F.POWER_USAGE): round(float(rng.uniform(60, 600)), 3),
                int(F.HBM_REMAP_PENDING): 0,
                int(F.ICI_LINKS_UP): 18,
            }
            for change_c, changes in SCRIPT.get(step, []):
                if change_c != c:
                    continue
                for f, v in changes.items():
                    if isinstance(v, tuple):
                        level[c][f] += v[1]
                    else:
                        vals[f] = v
            for f in COUNTERS:
                vals.setdefault(f, level[c][f])
            if c == BLANK_CHIP:
                for f in BLANK_FIELDS:
                    vals[f] = None
            frame[c] = vals
        frames.append(frame)
    return frames


def scripted(base, types, events, frames):
    """A backend over ``base`` serving ``frames``; ``advance()`` steps to
    the next frame and appends that step's EVENTS."""

    class Scripted(base):
        name = "scripted"

        def __init__(self):
            self.step = 0
            self._events = []

        def open(self):
            pass

        def close(self):
            pass

        def chip_count(self):
            return CHIPS

        def chip_info(self, index):
            return types.ChipInfo(index=index, uuid=f"GPU-scripted-{index}",
                                  name="Scripted H100",
                                  arch=types.ChipArch.UNKNOWN,
                                  firmware=FIRMWARE[index],
                                  power_limit_w=LIMIT_W)

        def versions(self):
            return types.VersionInfo()

        def topology(self, index):
            # three cards on one NVSwitch plane, one NUMA node each
            return types.TopologyInfo(
                coords=types.ChipCoords(x=index), cpu_affinity=f"{index}-7",
                numa_node=index % 2, mesh_shape=(CHIPS,),
                links=[types.P2PLink(chip_index=c, bus_id=f"0000:{c}8:00.0",
                                     link=types.P2PLinkType.ICI_NEIGHBOR,
                                     hops=1 + (c + index) % 2)
                       for c in range(CHIPS) if c != index])

        def read_fields(self, index, field_ids, now=None):
            vals = frames[self.step][index]
            out = {}
            for f in field_ids:
                if int(f) == int(F.FIRMWARE_VERSION):
                    out[f] = FIRMWARE[index]
                else:
                    out[f] = vals.get(int(f))
            return out

        def poll_events(self, since_seq):
            return [e for e in self._events if e.seq > since_seq]

        def current_event_seq(self):
            return self._events[-1].seq if self._events else 0

        def advance(self):
            self.step += 1
            for chip, etype, msg in EVENTS.get(self.step, []):
                self._events.append(events.Event(
                    etype=events.EventType[etype], timestamp=T0 + self.step,
                    seq=len(self._events) + 1, chip_index=chip,
                    message=msg))

    return Scripted()


def pair(seed: int = 0):
    """(port backend, reference backend) over the same script."""

    frames = script_frames(seed)
    return (scripted(Backend, TT, TEV, frames),
            scripted(JaxBackend, JT, JEV, frames))


def outcome(res):
    return (res.chip_index, res.status.name,
            [(i.system.name, i.status.name, i.message)
             for i in res.incidents])


def run_checks(ours, ref, backends, chips=range(CHIPS)):
    """Set every chip's watch at step 0, then advance and check each
    step; the two packages' outcomes, step by step."""

    got, want = [], []
    for c in chips:
        ours.set_watch(c)
        ref.set_watch(c)
    for _ in range(STEPS - 1):
        for b in backends:
            b.advance()
        for c in chips:
            got.append(outcome(ours.check(c)))
            want.append(outcome(ref.check(c)))
    return got, want


def clock():
    return T0


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_health_checks_equal_the_reference(seed):
    b, jb = pair(seed)
    got, want = run_checks(HealthMonitor(b, clock=clock),
                           JaxHealth(jb, clock=clock), (b, jb))
    assert got == want
    seen = {(sys_, st) for _, _, incs in got for sys_, st, _ in incs}
    # every scripted case reached an incident
    assert seen >= {("THERMAL", "WARN"), ("THERMAL", "FAIL"),
                    ("HBM", "WARN"), ("HBM", "FAIL"), ("PCIE", "WARN"),
                    ("ICI", "WARN"), ("ICI", "FAIL"), ("POWER", "WARN"),
                    ("FIRMWARE", "WARN"), ("RUNTIME", "FAIL")}


def test_one_event_gives_one_incident():
    """The event cursor: the step-11 CHIP_RESET shows in the check right
    after it and in no later one, in both packages."""

    b, jb = pair()
    ours, ref = HealthMonitor(b, clock=clock), JaxHealth(jb, clock=clock)
    ours.set_watch(1)
    ref.set_watch(1)
    runtime = []
    for _ in range(STEPS - 1):
        b.advance()
        jb.advance()
        got, want = outcome(ours.check(1)), outcome(ref.check(1))
        assert got == want
        runtime.append([m for s, _, m in got[2] if s == "RUNTIME"])
    assert runtime[10] == ["Xid 79", "runtime_restart event"]
    assert [r for k, r in enumerate(runtime) if k != 10] == [[]] * 12


def test_blank_counters_give_no_incident():
    """The chip whose PCIe and NVLink counters are blank (NOT_SUPPORTED)
    never reports PCIE or ICI from them; its NVLink event still counts
    nowhere but on its own chip."""

    b, jb = pair()
    got, want = run_checks(HealthMonitor(b, clock=clock),
                           JaxHealth(jb, clock=clock), (b, jb),
                           chips=[BLANK_CHIP])
    assert got == want
    assert not [i for _, _, incs in got for i in incs
                if i[0] in ("PCIE", "ICI")]


def test_baseline_is_taken_at_set():
    """Counters already non-zero at set trip nothing; re-setting the
    watch after the DBE moves the baseline past it."""

    b, jb = pair()
    ours, ref = HealthMonitor(b, clock=clock), JaxHealth(jb, clock=clock)
    for m in (ours, ref):
        m.set_watch(0)
    assert b.read_fields(0, [int(F.ECC_DBE_VOLATILE)])[
        int(F.ECC_DBE_VOLATILE)] > 0
    assert outcome(ours.check(0)) == outcome(ref.check(0)) == (0, "PASS", [])
    for _ in range(5):
        b.advance()
        jb.advance()
    first = outcome(ours.check(0))
    assert first == outcome(ref.check(0))
    assert ("HBM", "FAIL", "1 new double-bit ECC error(s)") in first[2]
    for m in (ours, ref):
        m.set_watch(0)
    again = outcome(ours.check(0))
    assert again == outcome(ref.check(0))
    assert not [i for i in again[2] if i[1] == "FAIL"]


def test_facade_health_equals_the_reference():
    """``Handle.health_set``/``health_check``, the REST API's source."""

    b, jb = pair(5)
    h, jh = tpumon_torch.Handle(b, clock=clock), tpumon.Handle(jb,
                                                             clock=clock)
    for c in range(CHIPS):
        h.health_set(c)
        jh.health_set(c, JT.HealthSystem.ALL)
    for _ in range(STEPS - 1):
        b.advance()
        jb.advance()
        for c in range(CHIPS):
            assert outcome(h.health_check(c)) == outcome(jh.health_check(c))
    assert h.chip_by_uuid("GPU-scripted-2").index == 2
    assert h.chip_by_uuid("nope") is None
    assert h.chip(1) is h.chip(1)
    mode, ref = h.chip_mode(0), jh.chip_mode(0)
    assert (mode.held, mode.holder_pids, mode.accounting) == \
        (ref.held, ref.holder_pids, ref.accounting) == (False, (), False)


# ---- over the fake NVML --------------------------------------------------------

from test_torch_nvml import (_build, _controls, NVML_ERROR_NOT_SUPPORTED,  # noqa: E402
                             wait_for)


@pytest.fixture(scope="module")
def fake_lib(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("nvml_health"), "libfake_nvml.so")


@pytest.fixture
def fake(fake_lib, tmp_path, monkeypatch):
    from tpumon_torch.backends import nvml as N

    monkeypatch.setattr(N.NvmlBackend, "EVENT_WAIT_MS", 20)
    monkeypatch.setenv("TPUMON_NVML_PATH", fake_lib)
    monkeypatch.setenv("TPUMON_KMSG_PATH", str(tmp_path / "no-kmsg"))
    monkeypatch.delenv("TPUMON_BACKEND", raising=False)
    return _controls(fake_lib)


def test_xid_79_over_nvml_is_runtime_fail(fake):
    h = tpumon_torch.init()
    try:
        h.health_set(0)
        assert h.health_check(0).status.name != "FAIL"
        fake.fake_nvml_inject_xid(0, 79)
        assert wait_for(lambda: h.backend.poll_events(0))
        res = h.health_check(0)
        assert res.status.name == "FAIL"
        assert [(i.system.name, i.status.name, i.message)
                for i in res.incidents
                if i.system.name == "RUNTIME"] == [("RUNTIME", "FAIL",
                                                    "Xid 79")]
        # one event, one incident
        assert not [i for i in h.health_check(0).incidents
                    if i.system.name == "RUNTIME"]
    finally:
        tpumon_torch.shutdown()


def test_refused_pcie_and_nvlink_counters_are_blank_over_nvml(fake):
    for fn in ("nvmlDeviceGetPcieReplayCounter",
               "nvmlDeviceGetNvLinkErrorCounter"):
        fake.fake_nvml_set_rc(fn.encode(), NVML_ERROR_NOT_SUPPORTED)
    h = tpumon_torch.init()
    try:
        for c in h.supported_chips():
            h.health_set(c)
            vals = h.backend.read_fields(c, [
                int(F.PCIE_REPLAY_COUNTER), int(F.ICI_CRC_ERRORS),
                int(F.ICI_REPLAY_ERRORS), int(F.ICI_RECOVERY_ERRORS)])
            assert set(vals.values()) == {None}
            fake.fake_nvml_advance(1_000_000, 1024)
            res = h.health_check(c)
            assert not [i for i in res.incidents
                        if i.system.name in ("PCIE", "ICI")], res
            assert res.status.name != "FAIL"
    finally:
        tpumon_torch.shutdown()


def test_firmware_is_the_vbios_version_over_nvml(fake):
    """Field 55 is the card's VBIOS: the fake's two cards run different
    ones, so the even split warns the lower version's card."""

    h = tpumon_torch.init()
    try:
        fw = [h.backend.read_fields(c, [int(F.FIRMWARE_VERSION)])[
            int(F.FIRMWARE_VERSION)] for c in (0, 1)]
        assert fw == [h.chip_info(c).firmware for c in (0, 1)]
        assert fw[0] != fw[1]
        low = fw.index(min(fw))
        res = h.health_check(low)
        assert [i.system.name for i in res.incidents] == ["FIRMWARE"]
        assert h.health_check(1 - low).status.name == "PASS"
    finally:
        tpumon_torch.shutdown()
