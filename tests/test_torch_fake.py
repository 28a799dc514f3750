"""The port's deterministic fake (``tpumon_torch/backends/fake.py``)
against the reference's (``tpumon/backends/fake.py``) and against the
native agent's ``FakeSource``.

* Every catalog field of every chip, at shared clock instants, in every
  topology preset, with burst mode, transients, overrides, blanks and
  injected events: the port's values equal the reference's exactly
  (repr: values and types), and so do inventory, topology and events.
* The reference's twelve ``FakeBackend`` cases, on the port.
* The port's fake evaluated at the native agent's own sample stamps
  (``native/build/tpu-hostengine --fake --fake-epoch E``) equals the
  native values within the reference's golden tolerances
  (``tests/test_agent.py``: 0 = exact, 155 and the profiling gauges by
  their declared rounding).
* ``make_backend("fake")`` honours ``TPUMON_FAKE_PRESET``; ``auto`` never
  yields the fake; the diag's event path injects through the fake and
  PASSes, as the reference's does.
"""

import json
import math
import os
import subprocess
import tempfile
import time

import pytest

from tpumon import fields as RF
from tpumon.backends import fake as RFake
from tpumon_torch import fields as FF
from tpumon_torch.backends import LibraryNotFound, make_backend
from tpumon_torch.backends.base import ChipNotFound
from tpumon_torch.backends.fake import FakeBackend, FakeClock, FakeSliceConfig
from tpumon_torch.events import EventType
from tpumon_torch.types import ChipArch, P2PLinkType

F = FF.F
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_AGENT = os.path.join(REPO, "native", "build", "tpu-hostengine")

#: the reference's golden tolerances (``tests/test_agent.py``): field ->
#: absolute tolerance, 0 = exact
GOLDEN = {
    100: 0, 101: 0, 140: 0, 150: 0, 155: 0.05001, 156: 1,
    200: 0, 201: 0, 202: 0, 203: 0, 204: 0, 206: 0, 207: 0, 208: 1,
    240: 1, 241: 1, 242: 0, 243: 0, 244: 0, 245: 0,
    250: 0, 251: 0, 252: 0, 253: 0, 310: 0, 311: 0, 312: 0, 313: 0,
    409: 0, 419: 0, 429: 0, 439: 0, 449: 0, 450: 0,
    1001: 5.1e-5, 1002: 5.1e-5, 1003: 5.1e-5, 1004: 5.1e-5,
    1005: 5.1e-5, 1006: 5.1e-5, 1007: 5.1e-5, 1008: 5.1e-5,
    1009: 1, 1010: 5.1e-5, 1011: 5.1e-5, 1012: 5.1e-5,
    1013: 5.1e-5, 1014: 5.1e-5,
}


def native_agent():
    """The native agent, built as the reference's tests build it; skip
    where the native toolchain is missing."""

    if not os.path.exists(NATIVE_AGENT):
        try:
            subprocess.run(["make", "-C", os.path.join(REPO, "native")],
                           check=True, capture_output=True, timeout=180)
        except (subprocess.CalledProcessError, FileNotFoundError,
                subprocess.TimeoutExpired):
            pass
    if not os.path.exists(NATIVE_AGENT):
        pytest.skip("native toolchain unavailable")
    return NATIVE_AGENT


@pytest.fixture
def fake_clock():
    return FakeClock(start=1_000_000.0)


@pytest.fixture
def backend(fake_clock):
    b = FakeBackend(config=FakeSliceConfig(num_chips=4), clock=fake_clock)
    b.open()
    yield b
    b.close()


def _pair(preset):
    """The port's and the reference's fake on one shared clock."""

    clock = FakeClock(start=1_000_000.0)
    cfg = getattr(FakeSliceConfig, preset)() if preset else None
    rcfg = getattr(RFake.FakeSliceConfig, preset)() if preset else None
    p = FakeBackend(config=cfg, clock=clock)
    r = RFake.FakeBackend(config=rcfg, clock=clock)
    p.open()
    r.open()
    return p, r, clock


def _plain(obj):
    """A dataclass tree as plain values (the two packages' enums are
    different classes with the same values)."""

    import dataclasses
    import enum

    if dataclasses.is_dataclass(obj):
        return {f.name: _plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return (type(obj).__name__, obj.value)
    if isinstance(obj, (list, tuple)):
        return [_plain(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    return obj


# -- the port against the reference, every field --------------------------------

@pytest.mark.parametrize("preset", [None, "v4_8", "v5e_8", "v5e_16",
                                    "v5e_256_multislice"])
def test_every_field_equals_the_reference(preset):
    p, r, clock = _pair(preset)
    fids = sorted(RF.CATALOG) + [99999]
    assert sorted(FF.CATALOG) == sorted(RF.CATALOG)
    n = p.chip_count()
    assert n == r.chip_count()
    for chip in range(n):
        assert _plain(p.chip_info(chip)) == _plain(r.chip_info(chip))
        assert _plain(p.topology(chip)) == _plain(r.topology(chip))
    assert _plain(p.versions()) == _plain(r.versions())
    for step in (0.0, 0.5, 37.25, 61.0, 3599.0, 7300.5):
        clock.advance(step)
        for chip in range(n):
            assert repr(p.read_fields(chip, fids)) == \
                repr(r.read_fields(chip, fids)), (chip, clock())
    # burst mode: the derived windows over the inner grid
    for b in (p, r):
        b.set_burst_hz(50)
        b.set_transient(1, int(F.POWER_USAGE), 7400.3, 0.2, 400.0)
    burst = [FF.burst_id(s, a) for s in FF.BURST_SOURCE_FIELDS
             for a in range(4)]
    for step in (0.0, 0.25, 0.5, 1.0):
        clock.advance(step)
        assert repr(p.read_fields(1, burst)) == repr(r.read_fields(1, burst))
    assert p.burst_stats() == r.burst_stats()


def test_faults_and_events_equal_the_reference():
    p, r, clock = _pair(None)
    fids = [int(f) for f in (F.CORE_TEMP, F.CHIP_RESET_COUNT,
                             F.RUNTIME_RESTART_COUNT, F.LAST_HEALTH_EVENT,
                             F.TENSORCORE_UTIL, F.HBM_PEAK_USED,
                             F.ICI_LINK_TX)]
    for b in (p, r):
        b.set_override(0, int(F.CORE_TEMP), 105)
        b.set_blank_fields(FF.PER_LINK_ICI_FIELDS)
        b.set_load_profile(lambda chip, t: 0.2 + 0.1 * chip
                           + (0.5 if 10 <= t < 12 else 0.0))
    for b, et in ((p, EventType), (r, RFake.EventType)):
        b.inject_event(et.CHIP_RESET, chip_index=1, message="reset",
                       code=7)
        b.inject_event(et.RUNTIME_RESTART, chip_index=2)
    for step in (0.0, 11.0, 5.0):
        clock.advance(step)
        for chip in range(4):
            assert repr(p.read_fields(chip, fids)) == \
                repr(r.read_fields(chip, fids))
    assert _plain(p.poll_events(0)) == _plain(r.poll_events(0))
    assert p.current_event_seq() == r.current_event_seq() == 2


# -- the reference's cases, on the port ------------------------------------------

def test_inventory(backend):
    assert backend.chip_count() == 4
    info = backend.chip_info(0)
    assert info.arch == ChipArch.V5E
    assert info.uuid.startswith("TPU-v5e-")
    assert info.dev_path == "/dev/accel0"
    assert info.hbm.total == 16 * 1024
    with pytest.raises(ChipNotFound):
        backend.chip_info(99)


def test_uuids_distinct(backend):
    uuids = {backend.chip_info(i).uuid for i in range(4)}
    assert len(uuids) == 4


def test_reads_are_deterministic(backend, fake_clock):
    fids = FF.STATUS_FIELDS
    a = backend.read_fields(1, fids)
    b = backend.read_fields(1, fids)
    assert a == b  # same t -> identical values
    fake_clock.advance(5.0)
    c = backend.read_fields(1, fids)
    assert c != a  # time moves the gauges


def test_counters_monotone(backend, fake_clock):
    prev = backend.read_fields(0, [int(F.TOTAL_ENERGY)])[int(F.TOTAL_ENERGY)]
    for _ in range(20):
        fake_clock.advance(7.0)
        cur = backend.read_fields(0, [int(F.TOTAL_ENERGY)])[int(F.TOTAL_ENERGY)]
        assert cur >= prev
        prev = cur


def test_hbm_accounting_consistent(backend):
    vals = backend.read_fields(2, [int(F.HBM_TOTAL), int(F.HBM_USED),
                                   int(F.HBM_FREE)])
    assert vals[int(F.HBM_TOTAL)] == vals[int(F.HBM_USED)] + vals[int(F.HBM_FREE)]


def test_dcn_blank_on_single_slice(backend):
    vals = backend.read_fields(0, [int(F.DCN_TX_THROUGHPUT)])
    assert vals[int(F.DCN_TX_THROUGHPUT)] is None


def test_dcn_present_on_multislice(fake_clock):
    b = FakeBackend(config=FakeSliceConfig.v5e_256_multislice(),
                    clock=fake_clock)
    b.open()
    fake_clock.advance(1.0)
    vals = b.read_fields(0, [int(F.DCN_TX_THROUGHPUT),
                             int(F.DCN_RX_THROUGHPUT)])
    assert vals[int(F.DCN_TX_THROUGHPUT)] is not None


def test_unknown_field_blank(backend):
    assert backend.read_fields(0, [99999])[99999] is None


def test_topology_neighbors(backend):
    topo = backend.topology(0)
    assert topo.mesh_shape == (2, 2)
    neighbor_types = {l.link for l in topo.links}
    assert P2PLinkType.ICI_NEIGHBOR in neighbor_types
    for l in topo.links:
        assert (l.hops == 1) == (l.link == P2PLinkType.ICI_NEIGHBOR)


def test_event_injection_bumps_counters(backend, fake_clock):
    before = backend.read_fields(1, [int(F.CHIP_RESET_COUNT)])
    assert before[int(F.CHIP_RESET_COUNT)] == 0
    seq0 = backend.current_event_seq()
    fake_clock.advance(1.0)
    backend.inject_event(EventType.CHIP_RESET, chip_index=1, message="reset!")
    after = backend.read_fields(1, [int(F.CHIP_RESET_COUNT)])
    assert after[int(F.CHIP_RESET_COUNT)] == 1
    evs = backend.poll_events(seq0)
    assert len(evs) == 1 and evs[0].etype == EventType.CHIP_RESET
    assert backend.poll_events(backend.current_event_seq()) == []


def test_events_with_equal_timestamps_not_dropped(backend, fake_clock):
    # seq cursor (not timestamps) drives delivery: two events at the same
    # frozen-clock instant must both be observable
    seq0 = backend.current_event_seq()
    backend.inject_event(EventType.ICI_ERROR, chip_index=0)
    seq1 = backend.current_event_seq()
    backend.inject_event(EventType.ICI_ERROR, chip_index=0)
    assert len(backend.poll_events(seq0)) == 2
    assert len(backend.poll_events(seq1)) == 1


def test_override(backend):
    backend.set_override(0, int(F.CORE_TEMP), 105)
    assert backend.read_fields(0, [int(F.CORE_TEMP)])[int(F.CORE_TEMP)] == 105
    backend.clear_override(0, int(F.CORE_TEMP))
    assert backend.read_fields(0, [int(F.CORE_TEMP)])[int(F.CORE_TEMP)] < 105


# -- against the native FakeSource ------------------------------------------------

def test_golden_against_the_native_fake_source():
    """The native agent runs with a pinned epoch and a 50 ms watch; the
    port's fake is evaluated at the agent's own sample stamps, so formula
    drift is an exact-value failure, not a tolerance smudge (the
    reference's ``test_cross_language_fake_parity``, on the port, read
    through the port's client)."""

    from tpumon_torch.backends.agent import AgentBackend

    agent = native_agent()
    epoch = time.time() - 37.5
    sock = tempfile.mktemp(prefix="tpumon-torch-golden-", suffix=".sock")
    proc = subprocess.Popen(
        [agent, "--domain-socket", sock, "--fake", "--fake-chips", "4",
         "--fake-epoch", repr(epoch)],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        b = AgentBackend(address=f"unix:{sock}", timeout_s=5.0,
                         connect_retry_s=10.0)
        b.open()
        try:
            b.ensure_watch(sorted(GOLDEN), freq_us=50_000, keep_age_s=30.0)
            port = FakeBackend(FakeSliceConfig(num_chips=4),
                               clock=lambda: epoch)
            port.open()
            mismatches, compared = [], 0
            deadline = time.time() + 20.0
            for chip in range(4):
                for fid, tol in GOLDEN.items():
                    got = b.agent_samples(chip, fid)
                    while len(got) < 2 and time.time() < deadline:
                        time.sleep(0.05)
                        got = b.agent_samples(chip, fid)
                    assert len(got) >= 2, f"no samples for field {fid}"
                    for ts, native_v in got[-2:]:
                        v = port.read_fields(chip, [fid], now=ts)[fid]
                        assert v is not None, f"port blank for {fid}"
                        compared += 1
                        if not math.isclose(float(v), native_v,
                                            abs_tol=tol or 1e-12,
                                            rel_tol=0.0):
                            mismatches.append((fid, chip, ts - epoch,
                                               native_v, v))
            assert not mismatches, mismatches[:10]
            assert compared >= 4 * len(GOLDEN)
        finally:
            b.close()
    finally:
        proc.terminate()
        proc.wait(timeout=10)


# -- selection -------------------------------------------------------------------

def test_make_backend_fake_honours_the_preset(monkeypatch):
    monkeypatch.setenv("TPUMON_FAKE_PRESET", "v5e_8")
    b = make_backend("fake")
    assert isinstance(b, FakeBackend) and b.chip_count() == 8
    monkeypatch.setenv("TPUMON_BACKEND", "fake")
    monkeypatch.delenv("TPUMON_FAKE_PRESET")
    assert make_backend().chip_count() == 4


def test_auto_never_yields_the_fake(monkeypatch, tmp_path):
    """With no NVML on the host, ``auto`` fails naming NVML alone, even
    with a fake preset in the environment."""

    monkeypatch.delenv("TPUMON_BACKEND", raising=False)
    monkeypatch.setenv("TPUMON_FAKE_PRESET", "v5e_8")
    monkeypatch.setenv("TPUMON_NVML_PATH", str(tmp_path / "no-nvml.so"))
    with pytest.raises(LibraryNotFound) as e:
        make_backend("auto")
    assert "fake" not in str(e.value) and "nvml" in str(e.value)


def test_diag_event_path_over_the_fake_injects_and_passes(capsys):
    """``diag -r 3 --backend fake``: the event path injects a CHIP_RESET
    through the fake's hook and PASSes, every row as the reference's
    diag over the reference's fake gives it."""

    from tpumon.cli import diag as RD
    from tpumon_torch.cli import diag as PD

    def rows(mod, argv):
        rc = mod.main(argv)
        out = capsys.readouterr().out
        return rc, {d["check"]: d["status"]
                    for d in map(json.loads, out.splitlines())}

    rc, port = rows(PD, ["--backend", "fake", "-r", "3", "--json"])
    ref_rc, ref = rows(RD, ["--backend", "fake", "-r", "3", "--json"])
    assert rc == ref_rc == 0
    assert port["event path"] == "PASS"
    assert port == ref
