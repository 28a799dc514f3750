"""The port's out-of-band NVML backend on a host without a GPU.

A fake NVML written in C (``tpumon_torch/testlib/fake_nvml.c``) is built
with the host's ``cc`` and loaded through ``TPUMON_NVML_PATH``, so the
backend's real ``dlopen``, its symbol resolution and its ctypes layouts
are what run.  Device i of the fake serves fixed values; each field is
held to its value converted by the catalog's unit rule.  The event buffer
is held to ``tpumon``'s ``LibTpuBackend`` on the same appends, and the
sample CLIs are driven end to end over the fake.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from tpumon_torch import fields as TF
from tpumon_torch.backends import LibraryNotFound, make_backend
from tpumon_torch.backends import nvml as N
from tpumon_torch.backends.base import ChipNotFound
from tpumon_torch.events import EventType
from tpumon_torch.types import P2PLinkType

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTLIB = os.path.join(REPO, "tpumon_torch", "testlib")
F = TF.F
MIB = 1024 * 1024

NVML_ERROR_NOT_SUPPORTED = 3
NVML_ERROR_NO_PERMISSION = 4
NVML_ERROR_GPU_IS_LOST = 15


def _cc():
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        pytest.skip("no C compiler on this host")
    return cc


def _build(tmp_dir, name, *defines):
    out = os.path.join(str(tmp_dir), name)
    subprocess.run([_cc(), "-shared", "-fPIC", "-I", TESTLIB, "-o", out,
                    os.path.join(TESTLIB, "fake_nvml.c"), "-lpthread",
                    *defines], check=True, capture_output=True, timeout=120)
    return out


@pytest.fixture(scope="module")
def fake_lib(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("nvml"), "libfake_nvml.so")


@pytest.fixture(scope="module")
def lean_lib(tmp_path_factory):
    """The fake without ECC, field values and events: a driver lacking
    those entry points."""

    return _build(tmp_path_factory.mktemp("nvml_lean"),
                  "libfake_nvml_lean.so", "-DOMIT_ECC",
                  "-DOMIT_FIELD_VALUES", "-DOMIT_EVENTS")


def _controls(path):
    lib = ctypes.CDLL(path)
    lib.fake_nvml_set_rc.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.fake_nvml_inject_xid.argtypes = [ctypes.c_int, ctypes.c_ulonglong]
    lib.fake_nvml_advance.argtypes = [ctypes.c_longlong, ctypes.c_ulonglong]
    lib.fake_nvml_reset()
    return lib


@pytest.fixture(autouse=True)
def _short_event_waits(monkeypatch):
    """close() joins the event thread, which waits in the fake's event set
    for EVENT_WAIT_MS: keep the tests' closes short."""

    monkeypatch.setattr(N.NvmlBackend, "EVENT_WAIT_MS", 20)


@pytest.fixture
def kmsg(tmp_path):
    path = tmp_path / "kmsg"
    path.write_text("4,1,1000,-;NVRM: Xid (PCI:0000:18:00): 79, before "
                    "the watcher started\n")
    return path


@pytest.fixture
def fake(fake_lib, kmsg, monkeypatch):
    """The fake's controls, reset, with the backend's environment set."""

    monkeypatch.setenv("TPUMON_NVML_PATH", fake_lib)
    monkeypatch.setenv("TPUMON_KMSG_PATH", str(kmsg))
    return _controls(fake_lib)


@pytest.fixture
def backend(fake):
    b = N.NvmlBackend()
    b.open()
    yield b
    b.close()


def append_record(path, message, seq=[100]):  # noqa: B006 — shared counter
    seq[0] += 1
    with open(path, "a") as f:
        f.write(f"3,{seq[0]},{seq[0] * 1000},-;{message}\n")


def wait_for(fn, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = fn()
        if got:
            return got
        time.sleep(0.02)
    return fn()


# ---- fields: each unit rule on device 1 -----------------------------------

#: field -> the value device 1 of the fake serves, in the catalog's unit
DEVICE1 = {
    F.TENSORCORE_CLOCK: 1756,                    # MHz
    F.HBM_CLOCK: 2619,                           # MHz
    F.HBM_TEMP: 53,                              # C, field value 82
    F.CORE_TEMP: 42,                             # C
    F.POWER_USAGE: 124.456,                      # 124456 mW -> W
    F.TOTAL_ENERGY: 987654322,                   # mJ
    F.PCIE_TX_THROUGHPUT: 1500,                  # KB/s
    F.PCIE_RX_THROUGHPUT: 2500,                  # KB/s
    F.PCIE_REPLAY_COUNTER: 7,
    F.TENSORCORE_UTIL: 87,                       # %
    F.HBM_BW_UTIL: 45,                           # %
    F.POWER_VIOLATION: 1000,                     # field 74: 1000123 ns -> us
    F.THERMAL_VIOLATION: 2000,
    F.SYNC_BOOST_VIOLATION: 3000,
    F.BOARD_LIMIT_VIOLATION: 4000,
    F.LOW_UTIL_VIOLATION: 5000,
    F.RELIABILITY_VIOLATION: 6000,
    F.HBM_TOTAL: 81559,                          # B -> MiB
    F.HBM_USED: 1234,                            # v2 used, B -> MiB
    F.HBM_FREE: 81559 - 512 - 1234 - 1,          # v2 free (5 B short)
    F.ECC_SBE_TOTAL: 11,
    F.ECC_DBE_TOTAL: 2,
    F.ECC_SBE_VOLATILE: 3,
    F.ECC_DBE_VOLATILE: 1,
    F.HBM_REMAPPED_SBE: 4,
    F.HBM_REMAPPED_DBE: 1,
    F.HBM_REMAP_PENDING: 0,
    F.ICI_CRC_ERRORS: 1 + 11 + 21 + 31,          # summed over links
    F.ICI_RECOVERY_ERRORS: 0 + 1 + 2 + 3,
    F.ICI_REPLAY_ERRORS: 0 + 2 + 4 + 6,
    F.ICI_LINKS_UP: 2,
    F.ICI_LINK_CRC_ERRORS: [1, 11, 21, 31],
    F.ICI_LINK_STATE: [1, 1, 0, 0],
    F.CHIP_NAME: "NVIDIA H100 80GB HBM3",
    F.CHIP_UUID: "GPU-00000000-1111-2222-3333-000000000001",
    F.HBM_PEAK_USED: None,                       # no NVML source
}


@pytest.mark.parametrize("fid", list(DEVICE1), ids=lambda f: f.name)
def test_field_unit_rule(backend, fid):
    v = backend.read_fields(1, [int(fid)])[int(fid)]
    want = DEVICE1[fid]
    assert v == want
    if TF.CATALOG[int(fid)].kind is TF.ValueKind.FLOAT and want is not None:
        assert isinstance(v, float)


def test_one_read_serves_every_field_at_once(backend):
    got = backend.read_fields(1, [int(f) for f in DEVICE1])
    assert got == {int(f): v for f, v in DEVICE1.items()}


def test_nvlink_rates_from_counter_deltas(backend, fake):
    ids = [int(F.ICI_LINK_TX), int(F.ICI_LINK_RX), int(F.ICI_TX_THROUGHPUT),
           int(F.ICI_RX_THROUGHPUT)]
    first = backend.read_fields(0, ids)
    assert all(v is None for v in first.values())  # no rate from one read
    # 1024 us later every link's TX counter grew by 1000 KiB x (link + 1):
    # 1000 x 1024 B per 1024 us is 1000 MB/s
    fake.fake_nvml_advance(1024, 1000)
    got = backend.read_fields(0, ids)
    assert got[int(F.ICI_LINK_TX)] == [1000, 2000, 3000, 4000]
    assert got[int(F.ICI_LINK_RX)] == [2000, 4000, 6000, 8000]
    assert got[int(F.ICI_TX_THROUGHPUT)] == 10000
    assert got[int(F.ICI_RX_THROUGHPUT)] == 20000
    # no time passed: no rate, never a fabricated 0
    assert backend.read_fields(0, ids)[int(F.ICI_TX_THROUGHPUT)] is None


@pytest.mark.parametrize("fn,rc,fids", [
    ("nvmlDeviceGetPowerUsage", NVML_ERROR_NOT_SUPPORTED,
     [F.POWER_USAGE]),
    ("nvmlDeviceGetPowerUsage", NVML_ERROR_NO_PERMISSION, [F.POWER_USAGE]),
    ("nvmlDeviceGetTotalEccErrors", NVML_ERROR_NO_PERMISSION,
     [F.ECC_SBE_TOTAL, F.ECC_DBE_TOTAL, F.ECC_SBE_VOLATILE,
      F.ECC_DBE_VOLATILE]),
    ("nvmlDeviceGetRemappedRows", NVML_ERROR_NOT_SUPPORTED,
     [F.HBM_REMAPPED_SBE, F.HBM_REMAPPED_DBE, F.HBM_REMAP_PENDING]),
    ("nvmlDeviceGetUtilizationRates", NVML_ERROR_NOT_SUPPORTED,
     [F.TENSORCORE_UTIL, F.HBM_BW_UTIL]),
    ("field:74", NVML_ERROR_NO_PERMISSION, [F.POWER_VIOLATION]),
    ("field:78", NVML_ERROR_NOT_SUPPORTED, [F.LOW_UTIL_VIOLATION]),
    ("nvmlDeviceGetNvLinkState", NVML_ERROR_NOT_SUPPORTED,
     [F.ICI_LINKS_UP, F.ICI_LINK_STATE, F.ICI_CRC_ERRORS,
      F.ICI_RECOVERY_ERRORS, F.ICI_REPLAY_ERRORS, F.ICI_LINK_CRC_ERRORS]),
    ("nvmlDeviceGetMemoryInfo_v2", NVML_ERROR_NOT_SUPPORTED,
     [F.HBM_TOTAL, F.HBM_USED, F.HBM_FREE]),
    ("nvmlDeviceGetFieldValues", NVML_ERROR_NO_PERMISSION,
     [F.HBM_TEMP, F.POWER_VIOLATION, F.THERMAL_VIOLATION,
      F.SYNC_BOOST_VIOLATION, F.BOARD_LIMIT_VIOLATION, F.LOW_UTIL_VIOLATION,
      F.RELIABILITY_VIOLATION]),
    ("field:82", NVML_ERROR_NOT_SUPPORTED, [F.HBM_TEMP]),
])
def test_refused_reads_are_blank(fake, fn, rc, fids):
    fake.fake_nvml_set_rc(fn.encode(), rc)
    b = N.NvmlBackend()
    b.open()
    try:
        got = b.read_fields(1, [int(f) for f in DEVICE1])
    finally:
        b.close()
    for f in DEVICE1:
        assert got[int(f)] == (None if f in fids else DEVICE1[f]), f.name


def test_missing_symbols_are_blank_and_not_capabilities(lean_lib, kmsg,
                                                        monkeypatch):
    monkeypatch.setenv("TPUMON_NVML_PATH", lean_lib)
    monkeypatch.setenv("TPUMON_KMSG_PATH", str(kmsg))
    _controls(lean_lib)
    b = N.NvmlBackend()
    b.open()
    try:
        caps = b.capabilities()
        got = b.read_fields(1, [int(f) for f in DEVICE1])
    finally:
        b.close()
    assert not {"ecc", "field_values", "events"} & set(caps)
    assert {"identity", "power", "memory", "nvlink"} <= set(caps)
    gone = {F.ECC_SBE_TOTAL, F.ECC_DBE_TOTAL, F.ECC_SBE_VOLATILE,
            F.ECC_DBE_VOLATILE, F.HBM_TEMP, F.POWER_VIOLATION,
            F.THERMAL_VIOLATION, F.SYNC_BOOST_VIOLATION,
            F.BOARD_LIMIT_VIOLATION, F.LOW_UTIL_VIOLATION,
            F.RELIABILITY_VIOLATION}
    for f, want in DEVICE1.items():
        assert got[int(f)] == (None if f in gone else want), f.name


def test_not_supported_is_asked_once(backend, fake):
    """NOT_SUPPORTED is for good: the field stays blank without another
    call, and an entry point that answered otherwise is asked again."""

    calls = []
    real = backend._fn["nvmlDeviceGetPowerUsage"]
    backend._fn["nvmlDeviceGetPowerUsage"] = \
        lambda *a: calls.append(1) or real(*a)
    fake.fake_nvml_set_rc(b"nvmlDeviceGetPowerUsage",
                          NVML_ERROR_NOT_SUPPORTED)
    for _ in range(3):
        assert backend.read_fields(0, [int(F.POWER_USAGE)]) == {
            int(F.POWER_USAGE): None}
    assert len(calls) == 1
    fake.fake_nvml_reset()
    assert backend.read_fields(1, [int(F.POWER_USAGE)]) == {
        int(F.POWER_USAGE): 124.456}  # another device: asked
    fake.fake_nvml_set_rc(b"nvmlDeviceGetTemperature",
                          NVML_ERROR_NO_PERMISSION)
    for _ in range(2):
        assert backend.read_fields(0, [int(F.CORE_TEMP)])[
            int(F.CORE_TEMP)] is None
    fake.fake_nvml_reset()
    assert backend.read_fields(0, [int(F.CORE_TEMP)])[int(F.CORE_TEMP)] == 41


def _spy(backend, name, log):
    """Record each call of one entry point (its field-values requests as
    (field id, scope) lists)."""

    real = backend._fn[name]

    def spy(*args):
        if name == "nvmlDeviceGetFieldValues":
            log.append([(v.fieldId, v.scopeId) for v in args[2][:args[1]]])
        else:
            log.append(args[1:-1])
        return real(*args)

    backend._fn[name] = spy


LINK_AND_ENERGY = (F.TOTAL_ENERGY, F.ICI_LINKS_UP, F.ICI_LINK_STATE,
                   F.ICI_CRC_ERRORS, F.ICI_LINK_CRC_ERRORS)


def test_one_field_values_request_a_sweep(backend):
    """The energy counter (field 83), the NVLink states (field 165, one
    entry a link), the violation counters and the memory temperature
    come in ONE field-values request a read; the old per-link and energy
    entry points are not called.  Until the links are known every link
    NVML may have is asked; a link that answered NOT_SUPPORTED is not
    asked again."""

    reqs, states, energy = [], [], []
    _spy(backend, "nvmlDeviceGetFieldValues", reqs)
    _spy(backend, "nvmlDeviceGetNvLinkState", states)
    _spy(backend, "nvmlDeviceGetTotalEnergyConsumption", energy)
    for _ in range(2):
        assert backend.read_fields(1, [int(f) for f in DEVICE1]) == {
            int(f): v for f, v in DEVICE1.items()}
    assert len(reqs) == 2 and states == [] and energy == []
    first, second = (set(r) for r in reqs)
    assert {(N.NVML_FI_DEV_NVLINK_GET_STATE, link)
            for link in range(N.NVML_NVLINK_MAX_LINKS)} <= first
    assert {(N.NVML_FI_DEV_TOTAL_ENERGY_CONSUMPTION, 0),
            (N.NVML_FI_DEV_MEMORY_TEMP, 0)} <= first
    assert {(f, s) for f, s in second
            if f == N.NVML_FI_DEV_NVLINK_GET_STATE} == {
        (N.NVML_FI_DEV_NVLINK_GET_STATE, link) for link in range(4)}


def test_field_reads_equal_the_old_calls(backend):
    """The field-values reads of link state and energy give what the old
    per-call reads give."""

    ids = [int(f) for f in LINK_AND_ENERGY]
    by_fields = backend.read_fields(0, ids)
    backend._fn["nvmlDeviceGetFieldValues"] = None   # the old calls only
    assert backend.read_fields(0, ids) == by_fields
    assert by_fields[int(F.TOTAL_ENERGY)] == 987654321
    assert by_fields[int(F.ICI_LINK_STATE)] == [1, 1, 0, 0]


@pytest.mark.parametrize("field,old", [
    (N.NVML_FI_DEV_TOTAL_ENERGY_CONSUMPTION,
     "nvmlDeviceGetTotalEnergyConsumption"),
    (N.NVML_FI_DEV_NVLINK_GET_STATE, "nvmlDeviceGetNvLinkState"),
])
def test_not_supported_field_falls_back_once(backend, fake, field, old):
    """A field the driver answers NOT_SUPPORTED is asked once; its values
    come from the old entry point from then on, every read."""

    fake.fake_nvml_set_rc(f"field:{field}".encode(),
                          NVML_ERROR_NOT_SUPPORTED)
    reqs, olds = [], []
    _spy(backend, "nvmlDeviceGetFieldValues", reqs)
    _spy(backend, old, olds)
    ids = [int(f) for f in LINK_AND_ENERGY]
    for _ in range(3):
        assert backend.read_fields(1, ids) == {
            int(f): DEVICE1[f] for f in LINK_AND_ENERGY}
    asked = [r for r in reqs if any(f == field for f, _ in r)]
    assert len(asked) == 1 and len(reqs) == 3
    if field == N.NVML_FI_DEV_NVLINK_GET_STATE:
        # the first read probes every link, then the four the fake has
        assert len(olds) == N.NVML_NVLINK_MAX_LINKS + 2 * 4
    else:
        assert len(olds) == 3


def test_lost_gpu_drops_the_chip_from_a_bulk_read(backend, fake):
    fake.fake_nvml_set_rc(b"nvmlDeviceGetClockInfo", NVML_ERROR_GPU_IS_LOST)
    with pytest.raises(ChipNotFound):
        backend.read_fields(0, [int(F.TENSORCORE_CLOCK)])
    assert backend.read_fields_bulk([(0, [int(F.TENSORCORE_CLOCK)])]) == {}


# ---- open, auto and the library's absence ------------------------------------

def test_missing_library_raises_library_not_found(monkeypatch):
    monkeypatch.setenv("TPUMON_NVML_PATH", "/nonexistent/libnvidia-ml.so.1")
    with pytest.raises(LibraryNotFound):
        N.NvmlBackend().open()


def test_a_library_that_is_not_nvml_raises_library_not_found(monkeypatch):
    import ctypes.util
    libc = ctypes.util.find_library("c")
    if libc is None:
        pytest.skip("no libc soname on this host")
    monkeypatch.setenv("TPUMON_NVML_PATH", libc)
    with pytest.raises(LibraryNotFound, match="not NVML"):
        N.NvmlBackend().open()


def test_failed_init_raises_library_not_found(fake):
    fake.fake_nvml_set_rc(b"nvmlInit_v2", 9)  # NVML_ERROR_DRIVER_NOT_LOADED
    with pytest.raises(LibraryNotFound, match="nvmlInit_v2"):
        N.NvmlBackend().open()


def test_auto_opens_nvml(fake, monkeypatch):
    monkeypatch.delenv("TPUMON_BACKEND", raising=False)
    b = make_backend()
    try:
        assert isinstance(b, N.NvmlBackend) and b.chip_count() == 2
    finally:
        b.close()


def test_auto_falls_through_on_zero_devices(fake, monkeypatch):
    monkeypatch.delenv("TPUMON_ALLOW_INPROCESS", raising=False)
    fake.fake_nvml_set_count(0)
    with pytest.raises(LibraryNotFound, match="zero devices"):
        make_backend("auto")
    b = make_backend("nvml")  # named: serves the empty inventory
    b.open()
    try:
        assert b.chip_count() == 0
    finally:
        b.close()


def test_auto_tries_the_inprocess_backend_only_when_allowed(fake,
                                                            monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fake.fake_nvml_set_count(0)
    monkeypatch.delenv("TPUMON_ALLOW_INPROCESS", raising=False)
    with pytest.raises(LibraryNotFound) as plain:
        make_backend("auto")
    assert "cuda:" not in str(plain.value)
    monkeypatch.setenv("TPUMON_ALLOW_INPROCESS", "1")
    with pytest.raises(LibraryNotFound) as allowed:
        make_backend("auto")
    assert "cuda:" in str(allowed.value)


# ---- inventory and topology --------------------------------------------------

def test_chip_info_from_nvml(fake, tmp_path, monkeypatch):
    root = tmp_path / "root"
    dev = root / "sys/bus/pci/devices/0000:28:00.0"
    dev.mkdir(parents=True)
    (dev / "numa_node").write_text("1\n")
    monkeypatch.setenv(N.SYSFS_ENV, str(root))
    backend = N.NvmlBackend()
    backend.open()
    try:
        info = backend.chip_info(1)
        with pytest.raises(ChipNotFound):
            backend.chip_info(2)
    finally:
        backend.close()
    assert (info.name, info.uuid, info.serial, info.firmware) == (
        "NVIDIA H100 80GB HBM3", "GPU-00000000-1111-2222-3333-000000000001",
        "1650000001", "96.00.74.00.01")
    assert info.dev_path == "/dev/nvidia1"
    assert info.pci.bus_id == "00000000:28:00.0"
    assert info.power_limit_w == 700.0
    assert (info.clocks_max.tensorcore, info.clocks_max.hbm) == (1980, 2619)
    assert info.hbm.total == 81559
    assert info.driver_version == "550.54.15"
    assert info.numa_node == 1


def test_topology_links_and_affinity(fake, tmp_path, monkeypatch):
    fake.fake_nvml_set_count(3)
    b = N.NvmlBackend()
    b.open()
    try:
        t0, t2 = b.topology(0), b.topology(2)
        fake.fake_nvml_set_rc(b"nvmlDeviceGetCpuAffinity",
                              NVML_ERROR_NOT_SUPPORTED)
        root = tmp_path / "root"
        dev = root / "sys/bus/pci/devices/0000:38:00.0"
        dev.mkdir(parents=True)
        (dev / "local_cpulist").write_text("8-11\n")
        monkeypatch.setenv(N.SYSFS_ENV, str(root))
        t2_sysfs = b.topology(2)
    finally:
        b.close()
    # device 0's link 0 reaches device 1; device 2 has no NVLink peer
    assert [(l.chip_index, l.link) for l in t0.links] == [
        (1, P2PLinkType.ICI_NEIGHBOR), (2, P2PLinkType.SAME_HOST_PCIE)]
    assert [l.link for l in t2.links] == [P2PLinkType.SAME_HOST_PCIE] * 2
    assert t0.cpu_affinity == "0-3" and t2.cpu_affinity == "8-11"
    assert t2_sysfs.cpu_affinity == "8-11"


def test_single_gpu_host_has_no_links(fake):
    fake.fake_nvml_set_count(1)
    b = N.NvmlBackend()
    b.open()
    try:
        assert b.topology(0).links == []
    finally:
        b.close()


@pytest.mark.parametrize("words,bits,want", [
    ([0b1111], 64, "0-3"),
    ([0b1011], 64, "0-1,3"),
    ([0, 0b1], 4, "4"),
    ([0xF0F], 64, "0-3,8-11"),
    ([0], 64, ""),
])
def test_cpulist(words, bits, want):
    assert N.cpulist(words, bits) == want


# ---- events ------------------------------------------------------------------

def test_xid_through_the_event_set(backend, fake):
    assert backend._xid_covered == {0, 1}
    fake.fake_nvml_inject_xid(1, 79)
    fake.fake_nvml_inject_xid(0, 13)   # no clear meaning in the catalog
    fake.fake_nvml_inject_xid(0, 48)
    evs = wait_for(lambda: [e for e in backend.poll_events(0)
                            if e.etype is EventType.ECC_DBE])
    assert evs
    got = [(e.etype, e.chip_index, e.message)
           for e in backend.poll_events(0)]
    assert got == [(EventType.CHIP_RESET, 1, "Xid 79"),
                   (EventType.ECC_DBE, 0, "Xid 48")]


def test_xid_seen_by_both_sources_counts_once(backend, fake, kmsg):
    append_record(kmsg, "NVRM: Xid (PCI:0000:28:00): 79, pid=1, GPU has "
                        "fallen off the bus.")
    fake.fake_nvml_inject_xid(1, 79)
    # an AER line is the kernel log's alone: it comes through
    append_record(kmsg, "pcieport 0000:00:03.0: AER: Corrected error "
                        "received: 0000:28:00.0")
    wait_for(lambda: len(backend.poll_events(0)) >= 2)
    time.sleep(0.3)  # a duplicate would land meanwhile
    got = [(e.etype, e.chip_index) for e in backend.poll_events(0)]
    assert sorted(got) == [(EventType.CHIP_RESET, 1),
                           (EventType.PCIE_ERROR, 1)]


def test_kmsg_xid_is_the_event_where_no_event_set_registers(
        lean_lib, kmsg, monkeypatch):
    monkeypatch.setenv("TPUMON_NVML_PATH", lean_lib)
    monkeypatch.setenv("TPUMON_KMSG_PATH", str(kmsg))
    _controls(lean_lib)
    b = N.NvmlBackend()
    b.open()
    try:
        assert b._xid_covered == frozenset()
        append_record(kmsg, "NVRM: Xid (PCI:0000:18:00): 48, pid=1, An "
                            "uncorrectable double bit error")
        evs = wait_for(lambda: b.poll_events(0))
    finally:
        b.close()
    # the record from before the watcher started is skipped (EOF start)
    assert [(e.etype, e.chip_index) for e in evs] == [(EventType.ECC_DBE, 0)]


def test_close_stops_both_event_sources(fake):
    b = N.NvmlBackend()
    b.open()
    th, watcher = b._event_thread, b._kmsg
    assert th is not None and th.is_alive() and watcher is not None
    b.close()
    assert not th.is_alive()
    assert watcher._thread is None
    b.close()  # idempotent


def test_event_buffer_matches_libtpu_backend():
    """The seq cursor and the drop-oldest bound of the bounded event
    buffer, against LibTpuBackend's on the same appends."""

    from tpumon.backends.libtpu import LibTpuBackend

    ref, port = LibTpuBackend(), N.NvmlBackend()
    types = list(EventType)
    for k in range(5000):
        args = (k % 3 - 1, types[k % len(types)], 1000.0 + k, f"event {k}")
        ref._append_event(*args)
        port._append_event(*args)

    def view(b, since):
        return [(e.seq, int(e.etype), e.chip_index, e.timestamp, e.message)
                for e in b.poll_events(since)]

    assert port.current_event_seq() == ref.current_event_seq() == 5000
    for since in (0, 903, 904, 4000, 4999, 5000):
        assert view(port, since) == view(ref, since)
    assert len(port.poll_events(0)) == 4096


# ---- the ABI probe -----------------------------------------------------------

def test_abi_probe_against_the_stand_in_header(tmp_path):
    """The probe chip_smoke.py compiles against the toolkit's nvml.h,
    compiled against the fake's stand-in header: it must print exactly
    what the ctypes mirrors expect (the fake's layouts are the mirrors')."""

    src = tmp_path / "probe.c"
    src.write_text(N.abi_probe_source())
    exe = tmp_path / "probe"
    subprocess.run([_cc(), "-I", TESTLIB, "-o", str(exe), str(src)],
                   check=True, capture_output=True, timeout=120)
    out = subprocess.run([str(exe)], check=True, capture_output=True,
                         text=True, timeout=60).stdout
    got, want = N.parse_abi_probe(out), N.abi_expected()
    assert got == want
    assert want["sizeof nvmlFieldValue_t"] == 40
    assert want["offsetof nvmlFieldValue_t.value"] == 32
    assert want["sizeof nvmlPciInfo_t"] == 68
    assert want["sizeof nvmlEventData_t"] == 32
    assert want["const nvmlMemory_v2"] == 40 | 2 << 24


# ---- the sample CLIs over the fake -------------------------------------------

def _cli(module, *args, env=None):
    return subprocess.run([sys.executable, "-m", f"tpumon_torch.cli.{module}",
                           *args], capture_output=True, text=True,
                          timeout=120, cwd=REPO, env=env)


@pytest.fixture
def cli_env(fake_lib, kmsg):
    env = dict(os.environ, TPUMON_NVML_PATH=fake_lib,
               TPUMON_KMSG_PATH=str(kmsg), PYTHONPATH=REPO)
    env.pop("TPUMON_BACKEND", None)
    return env


def test_dmon_over_nvml(cli_env):
    r = _cli("dmon", "-c", "2", "-d", "0.1", env=cli_env)
    assert r.returncode == 0, r.stderr
    rows = [ln for ln in r.stdout.splitlines() if not ln.startswith("#")]
    assert rows == ["     0  123.5    41      87     45       -        -   "
                    "1755    2619",
                    "     1  124.5    42      87     45       -        -   "
                    "1756    2619"] * 2


def test_deviceinfo_over_nvml(cli_env):
    r = _cli("deviceinfo", "--chip", "1", env=cli_env)
    assert r.returncode == 0, r.stderr
    assert "Device Path            : /dev/nvidia1" in r.stdout
    assert "PCI BusID              : 00000000:28:00.0" in r.stdout
    assert "Power Limit (W)        : 700.0" in r.stdout
    bad = _cli("deviceinfo", "--chip", "5", env=cli_env)
    assert bad.returncode == 2 and "no such chip" in bad.stderr


def test_topology_over_nvml(cli_env):
    r = _cli("topology", env=cli_env)
    assert r.returncode == 0, r.stderr
    assert "NVL/1" in r.stdout and "0-3" in r.stdout and "4-7" in r.stdout


def test_processinfo_over_nvml(cli_env):
    r = _cli("processinfo", "--warmup", "0.2", env=cli_env)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "No processes currently hold a GPU."


def test_diag_over_nvml_skips_what_is_not_ported(cli_env):
    r = _cli("diag", "-r", "3", "--json", env=cli_env)
    assert r.returncode == 0, r.stderr
    rows = {d["check"]: d for d in map(json.loads, r.stdout.splitlines())}
    assert rows["backend init"]["detail"] == "nvml"
    assert rows["status fields"]["status"] == "PASS"
    assert rows["topology"]["status"] == "PASS"
    # the health check runs (the fake's two VBIOS versions split evenly:
    # the lower one's card warns); no port backend injects events
    assert rows["health subsystems"] == {
        "check": "health subsystems", "status": "PASS",
        "detail": "all chips WARN"}
    assert rows["event path"]["status"] == "SKIP"
    assert "no injection hook" in rows["event path"]["detail"]
    assert not [d for d in rows.values() if d["status"] == "FAIL"]


def test_diag_evidence_over_nvml(cli_env):
    r = _cli("diag", "--evidence", env=cli_env)
    assert r.returncode == 0, r.stderr
    rep = json.loads(r.stdout)
    assert rep["nvml"] == {"found": True, "path": cli_env["TPUMON_NVML_PATH"]}
    fams = rep["families"]
    assert fams["backend"] == "nvml" and fams["live_count"] >= 20


# ---- the burst inner loop's read ---------------------------------------------

BURST = [155, 203, 204, 206]


def test_burst_read_takes_power_from_the_instant_field(backend):
    """The burst loop's power is ``NVML_FI_DEV_POWER_INSTANT`` (the
    fake's 151250 mW on device 1, apart from ``nvmlDeviceGetPowerUsage``'s
    124456): on the H100 the usage call is a 1 s average that shows none
    of a 250 ms square wave's swing (PERF.md, Findings, decision (a)).  A card
    costs one field-values request and one utilization call a tick; 206
    has no source and stays blank."""

    assert N.BURST_POWER_FIELD == N.NVML_FI_DEV_POWER_INSTANT
    reqs, power, util = [], [], []
    _spy(backend, "nvmlDeviceGetFieldValues", reqs)
    _spy(backend, "nvmlDeviceGetPowerUsage", power)
    _spy(backend, "nvmlDeviceGetUtilizationRates", util)
    for _ in range(3):
        assert backend.read_burst_fields([(0, BURST), (1, BURST)]) == {
            0: {155: 150.25, 203: 87, 204: 45, 206: None},
            1: {155: 151.25, 203: 87, 204: 45, 206: None}}
    assert reqs == [[(N.NVML_FI_DEV_POWER_INSTANT, 0)]] * 6
    assert power == [] and len(util) == 6
    # the 1 Hz sweep keeps nvmlDeviceGetPowerUsage (held to nvidia-smi)
    assert backend.read_fields(1, [155]) == {155: DEVICE1[F.POWER_USAGE]}


def test_burst_read_falls_back_to_the_usage_call_once_refused(backend, fake):
    fake.fake_nvml_set_rc(f"field:{N.NVML_FI_DEV_POWER_INSTANT}".encode(),
                          NVML_ERROR_NOT_SUPPORTED)
    reqs = []
    _spy(backend, "nvmlDeviceGetFieldValues", reqs)
    for _ in range(3):
        assert backend.read_burst_fields([(1, [155, 203])]) == {
            1: {155: DEVICE1[F.POWER_USAGE], 203: 87}}
    assert len(reqs) == 1  # asked once, then the usage call serves it


def test_burst_read_drops_a_lost_gpu(backend, fake):
    fake.fake_nvml_set_rc(b"nvmlDeviceGetUtilizationRates", 15)  # GPU_IS_LOST
    assert backend.read_burst_fields([(0, BURST), (1, [155])]) == {
        1: {155: 151.25}}
