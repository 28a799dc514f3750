"""The port's exporter daemon on the CPU: the textfile merge, the HTTP
surface, the run loop and the exporter CLI.

The merge cases of ``tests/test_exporter.py`` run through the port's and
the reference's ``TpuExporter`` over a backend serving the same values
(``test_torch_monitor._stub_backend``), on the same drop files and the
same pinned clock, and the two bodies must be equal byte for byte once
the self families whose values are timings or process stats are removed
(``tpumon_exporter_scrape_duration_seconds``, ``_sweep_phase_seconds``,
``_cpu_percent``, ``_memory_kb``), and the port's own served-request
families.  The CLI runs as a subprocess over the
fake NVML (``tpumon_torch/testlib/fake_nvml.c``, loaded through
``TPUMON_NVML_PATH``), as a deployment runs it over ``libnvidia-ml``.
"""

import ctypes
import gzip
import http.client
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import types

import pytest

import tpumon
import tpumon_torch
from tpumon import types as JT
from tpumon.backends.base import Backend as JaxBackend
from tpumon.exporter import exporter as JE
from tpumon_torch import _codec as TC
from tpumon_torch import types as TT
from tpumon_torch.backends.base import Backend
from tpumon_torch.backends.cuda import CudaBackend
from tpumon_torch.exporter import exporter as TE
from tpumon_torch.exporter.promtext import parse_families

from test_torch_monitor import _stub_backend, _values
from test_torch_nvml import _build, _controls

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _python_codec(monkeypatch):
    """Both packages' renders on their Python codecs: the
    ``tpumon_codec_native`` gauge reads which codec is loaded, and the
    port's native one (``tests/test_torch_codec_native.py``) may be."""

    monkeypatch.setattr(TC, "lib", None)
#: self families whose values are timings or process stats, and the
#: port's served-request families (``tpumon_exporter_request_phase_
#: seconds`` and its counter), which the reference does not serve
TIMING_FAMILIES = ("tpumon_exporter_scrape_duration_seconds",
                   "tpumon_exporter_sweep_phase_seconds",
                   "tpumon_exporter_cpu_percent",
                   "tpumon_exporter_memory_kb",
                   "tpumon_exporter_request_phase_seconds",
                   "tpumon_exporter_requests_total")
T0 = 2_000_000.0


def without_timings(text: str) -> str:
    return "\n".join(ln for ln in text.split("\n")
                     if not any(f in ln for f in TIMING_FAMILIES))


class _Stats:
    cpu_percent = 1.25
    memory_kb = 4096.0


class Pair:
    """The reference's and the port's exporter over the same values,
    each merging its own copy of one drop directory."""

    def __init__(self, tmp_path, monkeypatch, own_output=False, **kw):
        monkeypatch.setattr(JE._codec, "active", lambda: False)
        self.values = {c: _values(c) for c in range(2)}
        self.now = T0
        self.dirs = {}
        self.exps = {}
        for side, mod, base, types_mod, handle in (
                ("ref", JE, JaxBackend, JT, tpumon.Handle),
                ("port", TE, Backend, TT, tpumon_torch.Handle)):
            d = tmp_path / side
            d.mkdir()
            self.dirs[side] = d
            out = str(d / "gpu.prom") if own_output else None
            exp = mod.TpuExporter(
                handle(_stub_backend(base, types_mod, self.values)),
                interval_ms=1000, output_path=out,
                clock=lambda: self.now, merge_globs=[str(d / "*.prom")],
                **kw)
            # process stats vary run to run: pin them, so the gauges that
            # count the body's bytes agree too
            exp._self_mon = types.SimpleNamespace(status=_Stats)
            self.exps[side] = exp

    def write(self, name, text, age=0.0):
        for d in self.dirs.values():
            path = d / name
            path.write_text(text)
            os.utime(path, (self.now - age, self.now - age))

    def each(self, fn):
        for d in self.dirs.values():
            fn(d)

    def sweep(self, advance=1.0):
        """One sweep of each; their bodies must agree.  Returns the
        port's text."""

        self.now += advance
        ref = self.exps["ref"].sweep(now=self.now)
        port = self.exps["port"].sweep(now=self.now)
        assert without_timings(port) == without_timings(ref)
        return port


# ---- the merge cases (tests/test_exporter.py:458-680, :883-931) -------------

def case_fresh_families(p):
    p.write("workload.prom",
            "# HELP tpu_workload_step_time Embedded workload step time.\n"
            "# TYPE tpu_workload_step_time gauge\n"
            'tpu_workload_step_time{chip="0",uuid="GPU-x"} 8432.5\n')
    text = p.sweep()
    assert 'tpu_workload_step_time{chip="0",uuid="GPU-x"} 8432.5' in text
    assert "# TYPE tpu_workload_step_time gauge" in text
    text = p.sweep()  # the merge's self-metrics lag a sweep
    assert parse_families(text)["tpumon_exporter_merged_files"] == 1


def case_exporter_series_wins(p):
    base = p.sweep()
    own = next(ln for ln in base.splitlines()
               if ln.startswith("tpu_power_usage{"))
    sid = own[:own.find("}") + 1]
    p.write("dup.prom", "# HELP tpu_power_usage duplicate help\n"
                        "# TYPE tpu_power_usage gauge\n"
                        f"{sid} 9999.9\n", age=-1.0)
    text = p.sweep()
    assert "9999.9" not in text and "duplicate help" not in text
    assert text.count("# TYPE tpu_power_usage gauge") == 1
    assert sum(ln.startswith(sid) for ln in text.splitlines()) == 1


def case_stale_skipped(p):
    p.write("dead.prom", 'tpu_workload_step_time{chip="0"} 1.0\n', age=120.0)
    assert "tpu_workload_step_time" not in p.sweep()


def case_own_output_never_ingested(p):
    p.sweep()  # publishes gpu.prom, which the glob matches
    text = p.sweep()
    assert text.count("# TYPE tpu_power_usage gauge") == 1
    assert parse_families(text)["tpu_power_usage"] == 2


def case_malformed_lines_dropped(p):
    p.write("torn.prom", 'tpu_workload_ok{chip="0"} 1.5\n'
                         "tpu_workload_step_t\n"
                         'tpu_workload_bad{chip="0"} 12notanum\n'
                         'tpu_workload_inf{chip="0"} +Inf\n')
    text = p.sweep()
    assert 'tpu_workload_ok{chip="0"} 1.5' in text
    assert 'tpu_workload_inf{chip="0"} +Inf' in text
    assert "tpu_workload_step_t\n" not in text and "12notanum" not in text
    merge = p.exps["port"]._merge
    assert (merge.files, merge.series) == (1, 2)


def case_help_dedup_across_files(p):
    p.write("a.prom", "# HELP tpu_workload_foo from file a\n"
                      'tpu_workload_foo{src="a"} 1\n'
                      "# HELP tpu_workload_full full family\n"
                      "# TYPE tpu_workload_full gauge\n"
                      'tpu_workload_full{src="a"} 2\n')
    p.write("b.prom", "# HELP tpu_workload_foo from file b\n"
                      'tpu_workload_foo{src="b"} 3\n')
    text = p.sweep()
    assert text.count("# HELP tpu_workload_foo") == 1
    assert "from file b" not in text
    assert 'tpu_workload_foo{src="b"} 3' in text
    assert "# TYPE tpu_workload_full gauge" in text


def case_braces_in_label_values(p):
    p.write("braces.prom", 'tpu_workload_note{cfg="{a:1, b:2}"} 2\n'
                           'tpu_workload_note{cfg="{a:1, b:3}"} 5\n'
                           'tpu_workload_esc{msg="say \\"hi\\" {x}"} 7\n')
    text = p.sweep()
    assert 'tpu_workload_note{cfg="{a:1, b:2}"} 2' in text
    assert 'tpu_workload_note{cfg="{a:1, b:3}"} 5' in text
    assert 'tpu_workload_esc{msg="say \\"hi\\" {x}"} 7' in text


def case_fifo_and_symlink_skipped(p):
    def plant(d):
        os.mkfifo(str(d / "trap.prom"))
        os.symlink("/dev/zero", str(d / "link.prom"))
        os.utime(d / "trap.prom", (p.now, p.now), follow_symlinks=False)

    p.each(plant)
    p.write("good.prom", 'tpu_workload_ok{chip="0"} 1\n')
    done = {}
    th = threading.Thread(target=lambda: done.update(t=p.sweep()))
    th.start()
    th.join(timeout=10.0)
    assert not th.is_alive(), "sweep blocked on a FIFO in the drop dir"
    assert 'tpu_workload_ok{chip="0"} 1' in done["t"]


def case_oversized_truncated_at_line(p):
    p.exps["ref"].MERGE_MAX_BYTES = 1024
    p.exps["port"]._merge.max_bytes = 1024
    p.write("big.prom", "".join(f'tpu_workload_big{{i="{i}"}} {i}\n'
                                for i in range(200)))
    text = p.sweep()
    assert 'tpu_workload_big{i="0"} 0' in text
    assert 'tpu_workload_big{i="199"} 199' not in text
    for ln in text.splitlines():
        if ln.startswith("tpu_workload_big"):
            assert re.fullmatch(r'tpu_workload_big\{i="\d+"\} \d+', ln), ln


def case_same_family_samples_grouped(p):
    p.write("extra.prom",
            'tpu_power_usage{chip="9",uuid="GPU-9",model="Stub GPU"} 42.5\n')
    lines = p.sweep().splitlines()
    fam = [i for i, ln in enumerate(lines)
           if ln.startswith("tpu_power_usage{")]
    assert any('chip="9"' in lines[i] for i in fam)
    assert fam == list(range(fam[0], fam[0] + len(fam)))


def case_parse_cache_hit(p):
    parses = []
    ref = p.exps["ref"]
    real = type(ref)._parse_merge_content
    ref._parse_merge_content = (
        lambda content: parses.append(1) or real(content))
    merge = p.exps["port"]._merge
    real_port = merge.parse
    merge.parse = lambda content: parses.append(1) or real_port(content)
    p.write("cached.prom", 'tpu_workload_v{chip="0"} 1\n')
    assert 'tpu_workload_v{chip="0"} 1' in p.sweep()
    assert len(parses) == 2  # one parse a side
    assert 'tpu_workload_v{chip="0"} 1' in p.sweep()
    assert len(parses) == 2  # unchanged file: a stat, no parse
    p.write("cached.prom", 'tpu_workload_v{chip="0"} 2\n', age=-1.0)
    assert 'tpu_workload_v{chip="0"} 2' in p.sweep()
    assert len(parses) == 4


def case_cache_eviction(p):
    p.write("gone.prom", 'tpu_workload_gone{chip="0"} 1\n')
    assert "tpu_workload_gone" in p.sweep()
    for side, d in p.dirs.items():
        assert str(d / "gone.prom") in _merge_cache(p.exps[side])
        os.unlink(d / "gone.prom")
    assert "tpu_workload_gone" not in p.sweep()
    assert all(_merge_cache(exp) == {} for exp in p.exps.values())


def _merge_cache(exp):
    """The drop-file parse cache of either package's exporter."""

    merge = getattr(exp, "_merge", None)
    return merge.cache if merge is not None else exp._merge_cache


MERGE_CASES = {
    "fresh_families": case_fresh_families,
    "exporter_series_wins": case_exporter_series_wins,
    "stale_skipped": case_stale_skipped,
    "own_output_never_ingested": case_own_output_never_ingested,
    "malformed_lines_dropped": case_malformed_lines_dropped,
    "help_dedup_across_files": case_help_dedup_across_files,
    "braces_in_label_values": case_braces_in_label_values,
    "fifo_and_symlink_skipped": case_fifo_and_symlink_skipped,
    "oversized_truncated_at_line": case_oversized_truncated_at_line,
    "same_family_samples_grouped": case_same_family_samples_grouped,
    "parse_cache_hit": case_parse_cache_hit,
    "cache_eviction": case_cache_eviction,
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_matches_reference(case, tmp_path, monkeypatch):
    p = Pair(tmp_path, monkeypatch,
             own_output=case == "own_output_never_ingested")
    MERGE_CASES[case](p)
    text = p.sweep()  # and once more, with the self-metrics' one-sweep lag
    for ph in ("collect", "render", "merge", "publish"):
        assert f'phase="{ph}"' in text


def test_enricher_path_matches_reference(tmp_path, monkeypatch):
    """The text-level escape hatch: the full oracle render, the enricher,
    then the full-text merge and splice."""

    p = Pair(tmp_path, monkeypatch)
    for exp in p.exps.values():
        exp.set_enricher(lambda text: text.replace('model="Stub GPU"',
                                                   'model="Stub GPU",x="1"'))
    p.write("w.prom", 'tpu_power_usage{chip="7"} 1\n'
                      "# HELP tpu_workload_y y.\n"
                      'tpu_workload_y{chip="0"} 2\n')
    text = p.sweep()
    assert 'x="1"' in text and 'tpu_power_usage{chip="7"} 1' in text


# ---- pod labels at the label level -------------------------------------------

def test_pod_attributor_splices_labels_like_the_reference(tmp_path,
                                                          monkeypatch):
    from tpumon.exporter.podresources import PodInfo as JPod
    from tpumon_torch.exporter.podresources import PodInfo as TPod

    p = Pair(tmp_path, monkeypatch)
    maps = {"ref": {}, "port": {}}

    class Stub:
        def __init__(self, side):
            self.side = side

        def device_map(self):
            return maps[self.side]

        def lookup(self, mapping, uuid, chip):
            return mapping.get(uuid) or mapping.get(chip)

    for side, exp in p.exps.items():
        exp.set_pod_attributor(Stub(side))
    maps["ref"]["GPU-0"] = JPod("train-a", "ml", "worker")
    maps["port"]["GPU-0"] = TPod("train-a", "ml", "worker")
    text = p.sweep()
    line = next(ln for ln in text.splitlines()
                if ln.startswith('tpu_power_usage{chip="0"'))
    assert 'pod_name="train-a",pod_namespace="ml",container_name="worker"' \
        in line
    assert "pod_name" not in next(
        ln for ln in text.splitlines()
        if ln.startswith('tpu_power_usage{chip="1"'))
    maps["ref"].clear()
    maps["port"].clear()
    assert "pod_name" not in p.sweep()  # pod gone: labels removed


def test_failing_pod_map_keeps_the_sweep(tmp_path, monkeypatch):
    p = Pair(tmp_path, monkeypatch)

    class Broken:
        def device_map(self):
            raise OSError("kubelet down")

    for exp in p.exps.values():
        exp.set_pod_attributor(Broken())
    assert "tpu_power_usage" in p.sweep()


# ---- the reference's plane options ----------------------------------------------

@pytest.mark.parametrize("opt,val", [
    ("burst", True), ("burst_hz", 50), ("blackbox_dir", "/tmp/bb"),
    ("blackbox_max_bytes", 1 << 20), ("rules", object()),
    ("ici_per_link_modeled", True)])
def test_unported_planes_name_item_16b(opt, val, tmp_path):
    """Each plane option of the reference's exporter runs: the burst,
    recorder and anomaly planes (ROADMAP.md item 16b, parts 1-3) and the
    modeled per-link split (item 7), whose sweep equals the reference
    exporter's over the same backend (:func:`_modeled_pair`).  The
    recorder writes under ``tmp_path``, the rules are a real set."""

    from tpumon_torch import anomaly as TA

    h = tpumon_torch.Handle(_stub_backend(Backend, TT,
                                          {c: _values(c) for c in range(2)}))
    if opt == "ici_per_link_modeled":
        _modeled_pair()
        return
    if opt == "blackbox_dir":
        val = str(tmp_path / "bb")
    if opt == "rules":
        val = TA.Rules.from_dict({"version": 1, "detectors": [
            {"name": "busy", "field": 203, "type": "threshold",
             "above": -1}]})
    exp = TE.TpuExporter(h, output_path=None, **{opt: val})
    try:
        text = exp.sweep(now=T0)
    finally:
        exp.stop()
    fams = parse_families(text)
    if opt in ("burst", "burst_hz"):
        from tpumon_torch import fields as TF
        assert set(TF.EXPORTER_BURST_FIELDS) <= set(exp.field_ids)
        assert (exp._burst_sampler is not None) == (opt == "burst_hz")
    elif opt == "blackbox_dir":
        assert fams["tpumon_blackbox_frames_total"] == 1
        assert len(os.listdir(val)) == 1
    elif opt == "rules":
        assert fams["tpumon_anomaly_findings_total"] == 1
        assert exp.last_findings
    else:
        assert exp.blackbox is None and "tpumon_blackbox" not in text


def _modeled_pair():
    """``ici_per_link_modeled`` over a backend serving the NVLink aggregate
    (1200 MB/s on card 0, 0 on card 1) and blank per-link fields, with
    three NVLink peers a card: the port's sweep equals the reference's,
    three ``source="modeled"`` links a family a card at a third of the
    aggregate each; a real per-link value on any card stops the split."""

    from tpumon_torch import fields as TF

    tx, rx = int(TF.F.ICI_TX_THROUGHPUT), int(TF.F.ICI_RX_THROUGHPUT)
    link_tx, link_rx = int(TF.F.ICI_LINK_TX), int(TF.F.ICI_LINK_RX)
    values = {c: _values(c) for c in range(2)}
    for c, agg in ((0, 1200), (1, 0)):
        values[c].update({tx: agg, rx: agg, link_tx: None, link_rx: None})

    def with_topology(base, types_mod):
        stub = _stub_backend(base, types_mod, values)

        def topology(index):
            links = [types_mod.P2PLink(
                chip_index=i, bus_id="",
                link=types_mod.P2PLinkType.ICI_NEIGHBOR, hops=1)
                for i in range(3)]
            return types_mod.TopologyInfo(
                coords=types_mod.ChipCoords(x=index), links=links)

        stub.topology = topology
        return stub

    exps = {side: mod.TpuExporter(handle(with_topology(base, types_mod)),
                                  output_path=None, ici_per_link_modeled=True)
            for side, mod, handle, base, types_mod in (
                ("ref", JE, tpumon.Handle, JaxBackend, JT),
                ("port", TE, tpumon_torch.Handle, Backend, TT))}
    for exp in exps.values():
        # process stats vary between the two sweeps: pin them, as
        # :class:`Pair` does, so the gauges that count the body's bytes
        # agree too
        exp._self_mon = types.SimpleNamespace(status=_Stats)
    try:
        texts = {k: e.sweep(now=T0) for k, e in exps.items()}
        assert without_timings(texts["port"]) == \
            without_timings(texts["ref"])
        lines = [ln for ln in texts["port"].splitlines()
                 if 'source="modeled"' in ln]
        assert len(lines) == 2 * 2 * 3  # tx/rx x cards x links
        assert sum(ln.endswith(" 400.000") for ln in lines) == 6
        values[1][link_tx] = [5.0]
        first, texts = texts, {k: e.sweep(now=T0 + 1)
                               for k, e in exps.items()}
        assert without_timings(texts["port"]) == \
            without_timings(texts["ref"])
        for k, text in texts.items():
            # the size each served: its own previous exposition
            assert f'tpumon_exporter_scrape_bytes{{host="vm"}} ' \
                f'{len(first[k].encode())}\n' in text, k
        assert 'source="modeled"' not in texts["port"]
    finally:
        for e in exps.values():
            e.stop()


# ---- HTTP --------------------------------------------------------------------

@pytest.mark.parametrize("header", [
    None, "", "gzip", "GZIP", "deflate, gzip;q=0.5", "gzip;q=0",
    "gzip; q=0.0", "*", "*;q=0", "identity", "br, *", "gzip;q=0, *",
    "*;q=0, gzip", "deflate", "x-gzip", " gzip ;q=1.0"])
def test_accepts_gzip_matches_reference(header):
    from tpumon.httputil import accepts_gzip as ref
    from tpumon_torch.httputil import accepts_gzip as ours

    assert ours(header) == ref(header)


@pytest.fixture
def stub_exporter():
    h = tpumon_torch.Handle(_stub_backend(
        Backend, TT, {c: _values(c) for c in range(2)}))
    exp = TE.TpuExporter(h, interval_ms=100, output_path=None)
    yield exp
    exp.stop()


def test_payload_compressed_once_per_sweep(stub_exporter):
    exp = stub_exporter
    assert exp.payload(accept_gzip=True) == (b"", None)  # no sweep yet
    exp.sweep()
    b1, e1 = exp.payload(accept_gzip=True)
    b2, e2 = exp.payload(accept_gzip=True)
    assert e1 == e2 == "gzip" and b1 is b2
    plain, enc = exp.payload()
    assert enc is None and gzip.decompress(b1) == plain
    exp.sweep()
    b3, _ = exp.payload(accept_gzip=True)
    assert b3 is not b1 and gzip.decompress(b3) == exp.payload()[0]
    text = exp.sweep()  # the gauge covers the previous sweep's variant
    assert parse_families(text)["tpumon_exporter_scrape_gzip_bytes"] == 1


def _get(port, path, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
    try:
        conn.request("GET", path, headers=headers or {})
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        conn.close()


def test_metrics_server_routes_match_reference(stub_exporter, monkeypatch):
    """Statuses and bodies of both servers over exporters of the same
    values: 503 before the first sweep, then /metrics and /tpu/metrics
    200 with their buffer, gzip on request, /healthz 200, 404 otherwise."""

    monkeypatch.setattr(JE._codec, "active", lambda: False)
    values = {c: _values(c) for c in range(2)}
    ref = JE.TpuExporter(tpumon.Handle(_stub_backend(JaxBackend, JT, values)),
                         interval_ms=100, output_path=None)
    servers = [JE.MetricsHTTPServer(ref, port=0),
               TE.MetricsHTTPServer(stub_exporter, port=0)]
    for s in servers:
        s.start()
    try:
        seen = []
        for exp in (ref, stub_exporter):
            exp._self_mon = types.SimpleNamespace(status=_Stats)
        for phase in ("before", "after"):
            if phase == "after":
                ref.sweep(now=T0)
                stub_exporter.sweep(now=T0)
            row = []
            for s in servers:
                got = {}
                for path in ("/metrics", "/tpu/metrics", "/healthz",
                             "/nope", "/metrics?x=1"):
                    status, hdrs, body = _get(s.port, path)
                    got[path] = (status, hdrs.get("Content-Type"),
                                 without_timings(body.decode()))
                status, hdrs, body = _get(s.port, "/metrics",
                                          {"Accept-Encoding": "gzip"})
                got["gzip"] = (status, hdrs.get("Content-Encoding"),
                               hdrs.get("Vary"))
                row.append(got)
            assert row[0] == row[1]
            seen.append(row[1])
        before, after = seen
        assert before["/healthz"][0] == 503 and before["/nope"][0] == 404
        assert after["/healthz"] == (200, "text/plain", "ok")
        assert after["/metrics"][0] == after["/tpu/metrics"][0] == 200
        assert after["/metrics"][2] == without_timings(
            stub_exporter.last_text)
        assert after["gzip"] == (200, "gzip", "Accept-Encoding")
    finally:
        for s in servers:
            s.stop()


def test_healthz_goes_stale_when_sweeps_stop(stub_exporter):
    exp = stub_exporter
    assert exp.healthy() == (False, "no sweep yet")
    exp.sweep()
    assert exp.healthy() == (True, "ok")
    # max(3 intervals, 3 s) without a successful sweep
    exp._last_success_monotonic -= 2.9
    assert exp.healthy()[0]
    exp._last_success_monotonic -= 0.2
    ok, reason = exp.healthy()
    assert not ok and reason.startswith("last successful sweep")


def test_a_raising_sweep_keeps_the_cadence(stub_exporter, monkeypatch):
    """The loop outlives a failing source: it goes on sweeping at its
    interval, and /healthz turns 503 once sweeps stop succeeding."""

    exp = stub_exporter
    real = exp.handle.watches.update_all
    calls = []

    def flaky(*a, **k):
        calls.append(time.monotonic())
        if len(calls) > 2:
            raise RuntimeError("source lost")
        return real(*a, **k)

    monkeypatch.setattr(exp.handle.watches, "update_all", flaky)
    exp.start()
    deadline = time.monotonic() + 10
    while len(calls) < 8 and time.monotonic() < deadline:
        time.sleep(0.02)
    assert len(calls) >= 8 and exp.sweep_count == 2
    assert exp._thread is not None and exp._thread.is_alive()
    gaps = [b - a for a, b in zip(calls[2:], calls[3:])]
    assert all(g >= 0.08 for g in gaps), gaps  # the 100 ms cadence kept
    exp._last_success_monotonic -= 3.1
    assert not exp.healthy()[0]
    exp.stop()
    assert exp._thread is None


def test_text_http_server_stop_never_hangs(monkeypatch):
    """The reference's test, on the port's copy: a raising
    server_close() still reaps the serve thread, and stop() on a
    never-started server closes the socket without waiting."""

    from tpumon_torch.httputil import TextHTTPServer

    srv = TextHTTPServer(lambda path: (200, "text/plain", "ok\n"), port=0)
    srv.start()
    orig_close = srv.server.server_close

    def boom():
        raise RuntimeError("close wedged")

    monkeypatch.setattr(srv.server, "server_close", boom)
    with pytest.raises(RuntimeError, match="close wedged"):
        srv.stop()
    assert srv._thread is not None and not srv._thread.is_alive()
    orig_close()
    srv2 = TextHTTPServer(lambda path: (200, "text/plain", "ok\n"), port=0)
    srv2.stop()
    assert srv2.server.socket.fileno() == -1


# ---- NVML lifetime under the daemon's loop -----------------------------------

@pytest.fixture(scope="module")
def fake_lib(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("nvml"), "libfake_nvml.so")


def test_stop_releases_nvml_exactly_once(fake_lib, tmp_path, monkeypatch):
    from tpumon_torch.backends import nvml as N

    monkeypatch.setenv("TPUMON_NVML_PATH", fake_lib)
    monkeypatch.setenv("TPUMON_KMSG_PATH", str(tmp_path / "no-kmsg"))
    monkeypatch.setattr(N.NvmlBackend, "EVENT_WAIT_MS", 20)
    fake = _controls(fake_lib)
    fake.fake_nvml_inits.restype = ctypes.c_int
    fake.fake_nvml_shutdowns.restype = ctypes.c_int
    h = tpumon_torch.init()
    try:
        exp = TE.TpuExporter(h, interval_ms=20,
                             output_path=str(tmp_path / "gpu.prom"))
        exp.start()
        deadline = time.monotonic() + 10
        while exp.sweep_count < 5 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert exp.sweep_count >= 5
        assert h.backend._event_thread.is_alive()  # beside the sweeps
        exp.stop()
    finally:
        tpumon_torch.shutdown()
    assert (fake.fake_nvml_inits(), fake.fake_nvml_shutdowns()) == (1, 1)


# ---- the exporter CLI over the fake NVML -------------------------------------

@pytest.fixture
def cli_env(fake_lib, tmp_path):
    env = dict(os.environ, TPUMON_NVML_PATH=fake_lib,
               TPUMON_KMSG_PATH=str(tmp_path / "no-kmsg"), PYTHONPATH=REPO)
    for k in ("TPUMON_BACKEND", "TPUMON_POD_MAP_FILE", "TPUMON_CHIPS"):
        env.pop(k, None)
    return env


def _main(*args, env, timeout=60):
    return subprocess.run([sys.executable, "-m", "tpumon_torch.exporter.main",
                           *args], capture_output=True, text=True, cwd=REPO,
                          env=env, timeout=timeout)


def test_oneshot_serves_the_north_stars_families(cli_env):
    r = _main("--oneshot", "-o", "none", env=cli_env)
    assert r.returncode == 0, r.stderr
    fams = parse_families(r.stdout)
    per_chip = [k for k, n in fams.items() if k.startswith("tpu_") and n > 0]
    assert len(per_chip) >= 20, per_chip
    assert fams["tpu_power_usage"] == 2


def test_oneshot_imports_neither_torch_nor_jax(cli_env):
    code = ("import json, sys\n"
            "from tpumon_torch.exporter import main\n"
            "rc = main.main(['--oneshot', '-o', 'none', '-p', '--dcn'])\n"
            "print(json.dumps([rc, sorted(m for m in sys.modules if "
            "m.split('.')[0] in ('torch', 'jax', 'jaxlib', 'tpumon'))]))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, env=cli_env, timeout=60)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == [0, []]


def test_fields_flag_and_bad_field(cli_env):
    r = _main("--oneshot", "-o", "none", "-e", "155,tpu_core_temp",
              env=cli_env)
    assert r.returncode == 0, r.stderr
    fams = {k for k in parse_families(r.stdout) if k.startswith("tpu_")}
    assert fams == {"tpu_power_usage", "tpu_core_temp"}
    bad = _main("--oneshot", "-o", "none", "-e", "nope", env=cli_env)
    assert bad.returncode == 1 and "unknown field" in bad.stderr


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_http(port, path, want, timeout=20.0):
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        try:
            last = _get(port, path)
            if want(last):
                return last
        except OSError:
            pass
        time.sleep(0.05)
    raise AssertionError(f"{path} never answered as wanted: {last}")


def _serve(env, *args):
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpumon_torch.exporter.main", "-d", "100",
         "--port", str(port), *args], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, port


def _term(proc):
    proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=10)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_daemon_serves_metrics_and_healthz_then_stops_on_sigterm(
        cli_env, tmp_path):
    out = tmp_path / "gpu.prom"
    proc, port = _serve(cli_env, "-o", str(out))
    try:
        _wait_http(port, "/healthz", lambda r: r[0] == 200)
        status, hdrs, body = _wait_http(port, "/metrics",
                                        lambda r: b"tpu_power_usage" in r[2])
        assert hdrs["Content-Type"] == "text/plain; version=0.0.4"
        status, hdrs, gz = _get(port, "/tpu/metrics",
                                {"Accept-Encoding": "gzip"})
        assert status == 200 and hdrs["Content-Encoding"] == "gzip"
        assert b"tpu_power_usage" in gzip.decompress(gz)
        assert _get(port, "/nope")[0] == 404
        t0 = time.monotonic()
        assert _term(proc) == 0
        assert time.monotonic() - t0 < 5.0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = out.read_text()
    assert text.endswith("\n") and parse_families(text)["tpu_power_usage"] == 2
    assert not list(tmp_path.glob("*.swp"))


def test_daemon_merges_a_drop_file_and_splices_pod_labels(cli_env,
                                                          tmp_path):
    drop = tmp_path / "drop"
    drop.mkdir()
    (drop / "embed.prom").write_text(
        "# HELP tpu_trace_duty Measured duty.\n"
        "# TYPE tpu_trace_duty gauge\n"
        'tpu_trace_duty{chip="0",uuid="GPU-00000000-1111-2222-3333-'
        '000000000000",model="NVIDIA H100 80GB HBM3"} 0.93\n')
    pod_map = tmp_path / "pods.json"
    pod_map.write_text(json.dumps({
        "GPU-00000000-1111-2222-3333-000000000000":
            {"pod": "train-0", "namespace": "ml", "container": "w"},
        "nvidia1": {"pod": "train-1", "namespace": "ml", "container": "w"}}))
    env = dict(cli_env, TPUMON_POD_MAP_FILE=str(pod_map))
    proc, port = _serve(env, "-o", "none", "--pod-labels",
                        "--merge-textfile", str(drop / "*.prom"))
    try:
        _, _, body = _wait_http(port, "/metrics",
                                lambda r: b"tpu_trace_duty" in r[2])
        text = body.decode()
        assert 'model="NVIDIA H100 80GB HBM3"} 0.93' in text
        power = [ln for ln in text.splitlines()
                 if ln.startswith("tpu_power_usage{")]
        assert len(power) == 2
        assert 'chip="0"' in power[0] and 'pod_name="train-0"' in power[0]
        assert 'chip="1"' in power[1] and 'pod_name="train-1"' in power[1]
        assert all('pod_namespace="ml",container_name="w"' in ln
                   for ln in power)
        assert _term(proc) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_kubelet_socket_and_merge_max_age(cli_env, tmp_path):
    """``--kubelet-socket`` points pod attribution at a kubelet (a fake
    one here, answering for GPU 1 by its ``nvidia1`` index), and
    ``--merge-max-age`` skips a drop file older than it."""

    from test_torch_pod import _fake_kubelet
    from tpumon_torch.exporter.podresources import encode_pod_resources

    server, sock = _fake_kubelet(encode_pod_resources([
        ("train-1", "ml", [("w", "nvidia.com/gpu", ["nvidia1"])])]))
    drop = tmp_path / "drop"
    drop.mkdir()
    (drop / "fresh.prom").write_text('tpu_workload_fresh{chip="0"} 1\n')
    (drop / "old.prom").write_text('tpu_workload_old{chip="0"} 2\n')
    old = time.time() - 30.0
    os.utime(drop / "old.prom", (old, old))
    try:
        r = _main("--oneshot", "-o", "none", "--pod-labels",
                  "--kubelet-socket", sock, "--merge-textfile",
                  str(drop / "*.prom"), "--merge-max-age", "10",
                  env=cli_env)
    finally:
        server.stop(0)
    assert r.returncode == 0, r.stderr
    power = [ln for ln in r.stdout.splitlines()
             if ln.startswith("tpu_power_usage{")]
    assert "pod_name" not in power[0]
    assert 'chip="1"' in power[1] and 'pod_name="train-1"' in power[1]
    assert 'tpu_workload_fresh{chip="0"} 1' in r.stdout
    assert "tpu_workload_old" not in r.stdout


def test_wait_for_gpu_gives_up_within_its_bound(cli_env, tmp_path):
    env = dict(cli_env, TPUMON_NVML_PATH=str(tmp_path / "no-libnvidia-ml.so"))
    t0 = time.monotonic()
    r = _main("--oneshot", "-o", "none", "--wait-for-tpu", "1", env=env)
    elapsed = time.monotonic() - t0
    assert r.returncode == 1
    assert "waiting for the GPU stack" in r.stderr
    assert "cannot load NVML" in r.stderr.splitlines()[-1]
    assert elapsed < 15.0
    # without the gate it fails at once, and never serves another source
    r = _main("--oneshot", "-o", "none", env=env)
    assert r.returncode == 1 and r.stdout == ""
    assert "waiting" not in r.stderr


@pytest.mark.parametrize("flag", [
    ["--burst"], ["--burst-hz", "50"], ["--blackbox-dir", "/tmp/bb"],
    ["--blackbox-max-bytes", "4096"], ["--rules", "rules.yaml"],
    ["--stream-port", "9412"], ["--ici-per-link-modeled"],
    ["--connect", "unix:/tmp/agent.sock"], ["--start-agent"]])
def test_unported_plane_flags_exit_naming_item_16b(flag, capsys, cli_env,
                                                   tmp_path):
    """Each plane flag of the reference's CLI runs: ``--burst``,
    ``--burst-hz``, ``--blackbox-dir``, ``--blackbox-max-bytes``,
    ``--rules``, ``--stream-port`` and ``--ici-per-link-modeled`` (over
    the fake NVML; the recorder under ``tmp_path``, a real rules file;
    ``--oneshot`` returns before the stream plane binds, as in the
    reference); the agent run modes serve and scrape
    (:func:`_serve_through_an_agent`)."""

    if flag[0] in ("--connect", "--start-agent"):
        _serve_through_an_agent(flag[0], cli_env, tmp_path)
        return
    bb = tmp_path / "bb"
    rules = tmp_path / "rules.yaml"
    rules.write_text("version: 1\ndetectors:\n  - name: warm\n"
                     "    field: tpu_core_temp\n    type: threshold\n"
                     "    above: 1\n")
    argv = [{"/tmp/bb": str(bb), "rules.yaml": str(rules)}.get(a, a)
            for a in flag]
    r = _main(*argv, "--oneshot", "-o", "none", env=cli_env)
    assert r.returncode == 0, r.stderr
    fams = parse_families(r.stdout)
    want = {
        # the families are asked for, and blank without the inner loop
        "--burst": lambda: "tpu_power_usage_1s_min" not in fams,
        "--burst-hz": lambda: fams.get("tpumon_agent_burst_rate_hz") == 1,
        "--blackbox-dir": lambda: len(os.listdir(bb)) == 1,
        "--blackbox-max-bytes": lambda: "tpumon_blackbox_segments" not in
        fams,
        # both fake cards run warm: two firings of the one rule
        "--rules": lambda: re.search(
            r'^tpumon_anomaly_findings_total\{[^}]*rule="warm"\} 2$',
            r.stdout, re.M) is not None,
        "--stream-port": lambda: fams.get("tpu_power_usage") == 2 and
        "tpumon_stream_subscribers" not in fams,
        # NVML serves no NVLink aggregate here (nor on the H100): the
        # split has nothing to divide, and nothing is invented
        "--ici-per-link-modeled": lambda: 'source="modeled"' not in
        r.stdout and fams.get("tpu_ici_links_up") == 2}
    assert want[flag[0]](), r.stdout[-3000:]


def _children(pid):
    out = []
    for p in os.listdir("/proc"):
        try:
            with open(f"/proc/{p}/stat") as f:
                if int(f.read().rsplit(")", 1)[1].split()[1]) == pid:
                    out.append(int(p))
        except (OSError, ValueError, IndexError):
            continue
    return out


def _serve_through_an_agent(flag, env, tmp_path):
    """The daemon with ``--connect`` (to the port's agent over the fake
    NVML) or ``--start-agent`` (which starts one) serves on HTTP the
    per-card families the in-process daemon serves over the same NVML,
    with the same values, plus the agent's self-metrics and the sweep
    RPC's wire counters; its agent-side watch serves the sweep; on
    SIGTERM a started agent goes with it."""

    agent = None
    args = ["--start-agent"]
    if flag == "--connect":
        sock = str(tmp_path / "agent.sock")
        agent = subprocess.Popen(
            [sys.executable, "-m", "tpumon_torch.hostengine",
             "--domain-socket", sock], cwd=REPO, env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        args = ["--connect", f"unix:{sock}"]
        from tpumon_torch.backends.agent import AgentBackend
        probe = AgentBackend(address=args[1], connect_retry_s=30.0)
        probe.open()  # the agent answers before the daemon dials it
        probe.close()
    try:
        proc, port = _serve(env, *args, "-o", "none")
        try:
            _, _, body = _wait_http(
                port, "/metrics",
                lambda r: b"tpumon_agent_cpu_percent" in r[2])
            if flag == "--start-agent":
                started = _children(proc.pid)
                assert len(started) == 1
            text = body.decode()
        finally:
            assert _term(proc) == 0
        if flag == "--start-agent":
            assert not os.path.exists(f"/proc/{started[0]}")
    finally:
        if agent is not None:
            agent.terminate()
            agent.wait(timeout=10)
    fams = parse_families(text)
    assert fams["tpumon_exporter_sweep_rpc_bytes"] == 1
    assert fams["tpumon_agent_memory_kb"] == 1

    def card_samples(t):
        return sorted(ln for ln in t.splitlines()
                      if ln.startswith("tpu_") and 'chip="' in ln)

    embedded = _main("--oneshot", "-o", "none", env=env)
    assert embedded.returncode == 0, embedded.stderr
    assert card_samples(text) == card_samples(embedded.stdout)
    per_card = {k for k, n in fams.items() if k.startswith("tpu_") and n}
    assert len(per_card) >= 20, per_card


# ---- the burst, recorder and anomaly planes --------------------------------------

PLANE_RULES = ("version: 1\ndetectors:\n"
               "  - name: busy\n    field: TENSORCORE_UTIL\n"
               "    type: threshold\n    above: 80\n"
               "  - name: power_z\n    field: POWER_USAGE\n    type: ewma_z\n"
               "    z: 2\n    min_samples: 3\n"
               "incidents:\n  - name: busy_xid\n    window_s: 5\n"
               "    require:\n      - anomaly: busy\n      - kmsg: Xid\n")


def test_planes_render_the_reference_bytes(tmp_path, monkeypatch):
    """The reference's and the port's exporter with the three planes on,
    over the same values: each sweep's body (bar the timing families) and
    the recorder's segment files must be equal byte for byte.  The burst
    inner loops are stopped at once and fed the same seeded samples; the
    kmsg lines go through ``anomaly_kmsg`` on both."""

    import numpy as np
    from tpumon import anomaly as JA
    from tpumon import burst as JB
    from tpumon_torch import anomaly as TA
    from tpumon_torch import burst as TB

    monkeypatch.setattr(JE._codec, "active", lambda: False)
    rules = tmp_path / "rules.yaml"
    rules.write_text(PLANE_RULES)
    values = {c: _values(c) for c in range(2)}
    exps = {}
    for side, mod, base, types_mod, handle, amod, bmod in (
            ("ref", JE, JaxBackend, JT, tpumon.Handle, JA, JB),
            ("port", TE, Backend, TT, tpumon_torch.Handle, TA, TB)):
        exp = mod.TpuExporter(
            handle(_stub_backend(base, types_mod, values)),
            interval_ms=1000, output_path=None, clock=lambda: T0,
            burst_hz=50, blackbox_dir=str(tmp_path / side / "bb"),
            rules=amod.load_rules(str(rules)))
        exp._self_mon = types.SimpleNamespace(status=_Stats)
        s = exp._burst_sampler
        s.stop()
        s._acc, s._overruns = bmod.BurstAccumulator(), 3
        exps[side] = (exp, s)
    rng = np.random.default_rng(9)
    try:
        for k in range(8):
            now = T0 + k
            for c in range(2):
                values[c][203] = int(rng.choice([10, 90]))
                values[c][155] = float(rng.uniform(100, 600))
            samples = [(int(rng.integers(0, 2)), int(rng.choice(
                [155, 203, 204])), now - 1 + 0.02 * j,
                float(rng.uniform(0, 700))) for j in range(40)]
            texts = []
            for exp, s in exps.values():
                for chip, fid, t, v in samples:
                    s._acc.fold(chip, fid, t, v)
                if k in (2, 5):
                    assert exp.anomaly_kmsg(f"kernel: Xid note {k}",
                                            now - 0.5)
                texts.append(exp.sweep(now=now))
            assert without_timings(texts[1]) == without_timings(texts[0])
        fams = parse_families(texts[1])
        for fam in ("tpu_power_usage_1s_integral", "tpumon_agent_burst_rate_hz",
                    "tpumon_agent_burst_overruns_total",
                    "tpumon_blackbox_bytes_written_total",
                    "tpumon_anomaly_findings_total",
                    "tpumon_incident_findings_total"):
            assert fams.get(fam), fam
        assert exps["port"][0].last_findings
    finally:
        for exp, _ in exps.values():
            exp.stop()
    files = {}
    for side in exps:
        d = tmp_path / side / "bb"
        files[side] = {n: (d / n).read_bytes() for n in os.listdir(d)}
    assert files["port"] == files["ref"] and files["port"]


def test_burst_is_refused_over_the_cuda_backend(tmp_path):
    """A read of the burst fields on the embedded ``CudaBackend`` runs a
    probe or opens a trace session, so ``burst_hz`` over it fails the
    start, and the recorder it had opened is released."""

    stub = _stub_backend(Backend, TT, {c: _values(c) for c in range(2)})
    stub.read_burst_fields = CudaBackend().read_burst_fields
    with pytest.raises(ValueError, match="refused over the cuda backend"):
        TE.TpuExporter(tpumon_torch.Handle(stub), output_path=None,
                       burst_hz=100, blackbox_dir=str(tmp_path / "bb"))
    exp = TE.TpuExporter(tpumon_torch.Handle(stub), output_path=None,
                         burst=True)  # the families alone run anywhere
    exp.stop()


def test_oneshot_with_the_planes_imports_neither_torch_nor_jax(cli_env,
                                                              tmp_path):
    rules = tmp_path / "rules.yaml"
    rules.write_text(PLANE_RULES)
    code = ("import json, sys\n"
            "from tpumon_torch.exporter import main\n"
            f"rc = main.main(['--oneshot', '-o', 'none', '--burst-hz', '100',"
            f" '--blackbox-dir', {str(tmp_path / 'bb')!r}, '--rules', "
            f"{str(rules)!r}])\n"
            "print(json.dumps([rc, sorted(m for m in sys.modules if "
            "m.split('.')[0] in ('torch', 'jax', 'jaxlib', 'tpumon'))]))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, env=cli_env, timeout=60)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == [0, []]
    fams = parse_families(r.stdout)
    assert fams["tpumon_blackbox_frames_total"] == 1
    assert fams["tpu_power_usage_1s_max"] == 2  # one per fake card


def test_daemon_records_kmsg_lines_and_the_incident(cli_env, tmp_path):
    """The daemon with its three planes over the fake NVML, its kernel log
    a fixture file: an ``NVRM: Xid`` line appended while it runs is
    recorded, joins the incident naming the fake's card by its bus, and
    a backtest with that bus re-derives the recorded findings."""

    bb, rules, kmsg = tmp_path / "bb", tmp_path / "r.yaml", tmp_path / "kmsg"
    rules.write_text("version: 1\ndetectors:\n  - name: busy\n"
                     "    field: TENSORCORE_UTIL\n    type: threshold\n"
                     "    above: 80\nincidents:\n  - name: lost\n"
                     "    window_s: 30\n    require:\n"
                     "      - anomaly: busy\n      - event: CHIP_RESET\n")
    kmsg.write_text("")
    env = dict(cli_env, TPUMON_KMSG_PATH=str(kmsg))
    proc, port = _serve(env, "-o", "none", "--burst-hz", "100",
                        "--blackbox-dir", str(bb), "--rules", str(rules))
    try:
        _wait_http(port, "/healthz", lambda r: r[0] == 200)
        with open(kmsg, "a") as f:
            f.write("3,77,123,-;NVRM: Xid (PCI:0000:28:00): 79, pid=1, "
                    "GPU has fallen off the bus.\n")
        _wait_http(port, "/metrics", lambda r: b'tpumon_incident_findings_'
                   b'total{host="' in r[2] and b'rule="lost"} 1' in r[2])
    finally:
        assert _term(proc) == 0
    err = proc.stderr.read()
    assert "feeding kmsg lines" in err
    out = []
    for argv in (["--format", "json"],
                 ["--backtest", str(rules), "--format", "json", "--bus",
                  "0000:18:00=0", "--bus", "0000:28:00=1"]):
        r = subprocess.run([sys.executable, "-m", "tpumon_torch.cli.replay",
                            "--dir", str(bb), *argv], capture_output=True,
                           text=True, cwd=REPO, env=env, timeout=60)
        assert r.returncode == 0, r.stderr
        out.append([json.loads(ln) for ln in r.stdout.splitlines()])
    recorded = [o for o in out[0] if o["kind"] in ("anomaly", "incident")]
    assert [o for o in out[0] if o["kind"] == "kmsg"]
    assert out[1][:-1] == recorded
    (inc,) = [o for o in recorded if o["kind"] == "incident"]
    assert inc["evidence"][-1].endswith("#chip1")


def test_an_unusable_blackbox_dir_fails_the_start(cli_env, tmp_path):
    (tmp_path / "file").write_text("")
    r = _main("--oneshot", "-o", "none", "--blackbox-dir",
              str(tmp_path / "file" / "bb"), env=cli_env)
    assert r.returncode == 1 and "unusable" in r.stderr
    r = _main("--oneshot", "-o", "none", "--rules",
              str(tmp_path / "missing.yaml"), env=cli_env)
    assert r.returncode == 1 and "missing.yaml" in r.stderr
