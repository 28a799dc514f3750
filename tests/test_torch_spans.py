"""The port's monitor spans (``tpumon_torch.spans``) on the CPU: the
recorder's parentage, aggregates and ring bound; the embedded sweep's
span tree over the CUDA backend with the probes on the CPU; the
exporter's sweep-phase and request-phase families served from the spans;
the profiler ranges that mirror the spans inside the trace engine's own
session and only there; and the trace engine's parse and capture
intervals with spans about.
"""

import dataclasses
import http.client
import re
import threading
import time

import pytest
import torch

import tpumon_torch
from tpumon_torch import fields as TF
from tpumon_torch import spans as S
from tpumon_torch import trace as T
from tpumon_torch.backends.base import Backend
from tpumon_torch.backends.probes import ProbeEngine
from tpumon_torch.exporter import exporter as TE
from tpumon_torch.exporter.promtext import parse_families

from test_torch_monitor import _stub_backend, _stub_cuda, _values

F = TF.F
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---- the recorder ------------------------------------------------------------

def test_children_nest_under_the_innermost_open_span():
    rec = S.Recorder()
    with rec.root("sweep") as root:
        with S.span("collect") as collect:
            with S.span("probe"):
                with S.span("drain"):
                    pass
            assert S.current() is collect
        with S.span("render"):
            pass
    assert S.current() is None
    tree = rec.last("sweep")
    by = {sp.name: sp for sp in tree}
    assert [sp.name for sp in tree] == [
        "sweep.collect.probe.drain", "sweep.collect.probe",
        "sweep.collect", "sweep.render", "sweep"]
    assert by["sweep"].id == root.id and by["sweep"].parent == 0
    assert by["sweep.collect"].parent == root.id
    assert by["sweep.collect.probe"].parent == by["sweep.collect"].id
    assert by["sweep.collect.probe.drain"].parent == \
        by["sweep.collect.probe"].id
    assert {sp.root for sp in tree} == {root.id}
    for sp in tree:
        assert sp.start_ns <= sp.end_ns
        if sp.parent:
            parent = next(p for p in tree if p.id == sp.parent)
            assert parent.start_ns <= sp.start_ns <= sp.end_ns <= \
                parent.end_ns


def test_outside_a_root_a_span_records_nothing():
    rec = S.Recorder()
    with S.span("probe") as sp:
        assert sp is None
    assert rec.spans() == [] and rec.aggregates() == {}
    assert S.current() is None


def test_totals_are_the_durations_and_a_recorder_keeps_no_ring_unasked():
    rec = S.Recorder()
    with rec.root("sweep"):
        time.sleep(0.01)
        with S.span("collect"):
            time.sleep(0.02)
        with S.span("render"):
            time.sleep(0.01)
    by = {sp.name: sp for sp in rec.last("sweep")}
    root = by["sweep"]
    assert root.ns >= by["sweep.collect"].ns + by["sweep.render"].ns \
        + 10_000_000
    assert rec.aggregates() == {
        name: (1, pytest.approx(sp.ns / 1e9)) for name, sp in by.items()}
    # the last tree and the aggregates only: no ring without a capacity
    assert rec.spans() == []


def test_aggregates_sum_every_root_and_a_repeated_phase():
    rec = S.Recorder()
    for _ in range(3):
        with rec.root("sweep"):
            for _ in range(2):     # one phase twice in a root
                with S.span("trace"):
                    pass
    agg = rec.aggregates()
    assert agg["sweep"][0] == 3 and agg["sweep.trace"][0] == 6
    secs = S.seconds(rec.last("sweep"))
    trace = [sp for sp in rec.last("sweep") if sp.name == "sweep.trace"]
    assert len(trace) == 2
    assert secs["sweep.trace"] == pytest.approx(
        sum(sp.ns for sp in trace) / 1e9)
    assert rec.latest("sweep") == (3, rec.last("sweep"))
    assert "nope" not in agg


def test_the_ring_is_bounded_and_the_aggregates_are_not():
    rec = S.Recorder(capacity=7)
    for _ in range(10):
        with rec.root("sweep"):
            with S.span("collect"):
                pass
    ring = rec.spans()
    assert len(ring) == 7
    assert ring[-1].name == "sweep"
    assert rec.aggregates()["sweep"][0] == 10
    assert rec.aggregates()["sweep.collect"][0] == 10


def test_recorded_tree_and_backdated_children():
    rec = S.Recorder()
    root = rec.record("capture", 100, 900, [("open", 100, 200),
                                            ("window", 200, 700),
                                            ("close", 700, 800),
                                            ("parse", 800, 900)])
    assert (root.start_ns, root.end_ns, root.parent) == (100, 900, 0)
    tree = rec.last("capture")
    assert [sp.name for sp in tree] == ["capture.open", "capture.window",
                                        "capture.close", "capture.parse",
                                        "capture"]
    assert all(sp.parent == root.id for sp in tree[:-1])
    with rec.root("request", 1_000) as req:
        req.add("wait", 1_000, 5_000)
    by = {sp.name: sp for sp in rec.last("request")}
    assert by["request"].start_ns == 1_000
    assert (by["request.wait"].start_ns, by["request.wait"].end_ns) == \
        (1_000, 5_000)


def test_threads_keep_their_own_stacks():
    rec = S.Recorder(capacity=1000)
    go = threading.Barrier(4)

    def worker(k):
        go.wait(timeout=10)
        for _ in range(50):
            with rec.root("request"):
                with S.span("payload"):
                    pass
                with S.span("write"):
                    pass

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    agg = rec.aggregates()
    assert agg["request"][0] == 200
    assert agg["request.payload"][0] == agg["request.write"][0] == 200
    assert set(agg) == {"request", "request.payload", "request.write"}
    roots = {sp.id for sp in rec.spans() if sp.parent == 0}
    assert all(sp.root in roots for sp in rec.spans() if sp.parent)


# ---- the embedded sweep ------------------------------------------------------

class _Engine:
    """The trace engine's two calls a sweep makes."""

    def peek(self, index):
        return None

    def sample(self, index, wait=False):
        return None


def _embedded(min_interval_s):
    """An exporter over the CUDA backend whose probes run on the CPU at
    small sizes and whose trace engine is a stub; the probes calibrated."""

    b = _stub_cuda(trace=True)
    del b._probe_sample          # the backend's own, over a real engine
    eng = ProbeEngine("cpu", min_interval_s=min_interval_s)
    eng.MM_N, eng.STREAM_MIB = 64, 1
    eng.warmup()
    b._probes[0] = eng
    b._trace = _Engine()
    exp = TE.TpuExporter(tpumon_torch.Handle(b), profiling=True,
                         output_path=None)
    return exp


def test_embedded_sweep_span_tree_names_every_phase():
    exp = _embedded(min_interval_s=0.0)
    exp.sweep()
    names = {sp.name for sp in exp.spans.last("sweep")}
    assert {"sweep", "sweep.collect", "sweep.collect.hbm_stats",
            "sweep.collect.probe", "sweep.collect.probe.drain",
            "sweep.collect.probe.rounds", "sweep.collect.trace",
            "sweep.collect.trace.peek", "sweep.collect.trace.schedule",
            "sweep.render", "sweep.merge", "sweep.publish"} <= names
    tree = exp.spans.last("sweep")
    assert sum(sp.name == "sweep.collect.trace" for sp in tree) == 2
    # the drain and the rounds are the probe, near enough all of it
    by = {sp.name: sp for sp in tree}
    probe = by["sweep.collect.probe"]
    assert by["sweep.collect.probe.drain"].ns + \
        by["sweep.collect.probe.rounds"].ns <= probe.ns


def test_a_cached_probe_records_no_probe_children():
    exp = _embedded(min_interval_s=60.0)
    exp.sweep()            # measures
    exp.sweep()            # serves the cached sample
    names = [sp.name for sp in exp.spans.last("sweep")]
    assert "sweep.collect.probe" in names
    assert not any(n.startswith("sweep.collect.probe.") for n in names)
    agg = exp.spans.aggregates()
    assert agg["sweep.collect.probe"][0] == 2
    assert agg["sweep.collect.probe.drain"][0] == 1
    assert agg["sweep.collect.probe.rounds"][0] == 1


# ---- the exporter's served families ------------------------------------------

def _exporter(**kw):
    values = {c: _values(c) for c in range(2)}
    return TE.TpuExporter(
        tpumon_torch.Handle(_stub_backend(Backend, tpumon_torch.types,
                                          values)),
        output_path=None, **kw)


def _samples(text, family):
    return {m.group(1): float(m.group(2)) for m in re.finditer(
        family + r'\{host="[^"]*",phase="(\w+)"\} ([0-9.e+-]+)', text)}


def test_sweep_phase_family_keeps_its_phases_and_its_lag(tmp_path):
    (tmp_path / "job.prom").write_text("job_x 1\n")
    exp = _exporter(merge_globs=[str(tmp_path / "*.prom")])
    first = exp.sweep()
    # the first sweep serves no phase yet: one sweep late
    assert "tpumon_exporter_sweep_phase_seconds" not in first
    fams = parse_families(first)
    assert "tpumon_exporter_scrape_duration_seconds" in fams
    prev = S.seconds(exp.spans.last("sweep"))
    second = exp.sweep()
    got = _samples(second, "tpumon_exporter_sweep_phase_seconds")
    assert list(got) == ["collect", "render", "merge", "publish"]
    for ph, v in got.items():
        assert v == pytest.approx(prev["sweep." + ph], abs=1e-6)
    m = re.search(r"tpumon_exporter_scrape_duration_seconds\{[^}]*\} "
                  r"([0-9.]+)", second)
    assert float(m.group(1)) == pytest.approx(prev["sweep"], abs=1e-6)
    assert exp.sweep_phases() == {
        name.split(".", 1)[1]: s for name, s in
        S.seconds(exp.spans.last("sweep")).items() if name.count(".") == 1}


def test_sweep_phase_family_keeps_a_raising_sweeps_predecessor(monkeypatch):
    exp = _exporter()
    exp.sweep()
    before = exp.sweep_phases()
    monkeypatch.setattr(exp.renderer, "render_parts",
                        lambda *a: (_ for _ in ()).throw(OSError("x")))
    with pytest.raises(OSError):
        exp.sweep()
    assert exp.sweep_phases() == before
    assert exp.spans.aggregates()["sweep"][0] == 2


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def test_request_phase_family_is_served_after_a_request():
    exp = _exporter()
    srv = TE.MetricsHTTPServer(exp, port=0)
    srv.start()
    try:
        body = exp.sweep()
        assert "tpumon_exporter_request_phase_seconds" not in body
        assert "tpumon_exporter_requests_total" not in body
        t0 = time.monotonic_ns()
        assert _get(srv.port, "/metrics")[0] == 200
        wall = time.monotonic_ns() - t0
        assert _get(srv.port, "/healthz")[0] == 200   # not timed
        body = exp.sweep()
        got = _samples(body, "tpumon_exporter_request_phase_seconds")
        assert list(got) == ["wait", "payload", "write"]
        assert sum(got.values()) <= wall / 1e9 + 1e-5
        assert re.search(r'tpumon_exporter_requests_total\{host="[^"]*"\} 1$',
                         body, re.M)
        tree = exp.spans.last("request")
        by = {sp.name: sp for sp in tree}
        assert set(by) == {"request", "request.wait", "request.payload",
                           "request.write"}
        # wait runs from the accept to the handler, then payload, write
        assert by["request"].start_ns == by["request.wait"].start_ns
        assert by["request.wait"].end_ns <= by["request.payload"].start_ns
        assert by["request.payload"].end_ns <= by["request.write"].start_ns
        for _ in range(2):
            assert _get(srv.port, "/tpu/metrics")[0] == 200
        body = exp.sweep()
        assert re.search(r'tpumon_exporter_requests_total\{host="[^"]*"\} 3$',
                         body, re.M)
        assert srv.server.accepted == {}
    finally:
        srv.stop()


# ---- the profiler ranges -----------------------------------------------------

def _user_ranges(events):
    return [e.name() for e in events if e.name().startswith(S.PREFIX)]


def _cpu_engine(monkeypatch, got):
    """A trace engine whose sessions are real CPU-only profiler sessions;
    each closed session's events land in ``got``."""

    from torch.profiler import ProfilerActivity, profile

    def start(eng):
        prof = profile(activities=[ProfilerActivity.CPU])
        prof.start()
        return prof

    def stop(prof):
        prof.stop()
        return prof.profiler.kineto_results

    def collect(eng, result, window_s):
        got.append(list(result.events()))
        return {}

    monkeypatch.setattr(T.TraceEngine, "_start_profiler", start)
    monkeypatch.setattr(T.TraceEngine, "_stop_profiler", staticmethod(stop))
    monkeypatch.setattr(T.TraceEngine, "_collect", collect)
    return T.TraceEngine(capture_ms=20.0, min_interval_s=0.0)


def test_spans_are_profiler_ranges_inside_a_session_only(monkeypatch):
    got = []
    eng = _cpu_engine(monkeypatch, got)
    rec = S.Recorder()
    with rec.root("sweep"):             # no session: no range entered
        with S.span("collect") as sp:
            assert sp.rf is None

    def step():
        with rec.root("sweep"):
            with S.span("collect"):
                torch.ones(4).add_(1.0)

    assert eng.capture_now(timeout_s=10.0, step=step)
    assert len(got) == 1
    names = _user_ranges(got[0])
    assert set(names) == {"tpumon.sweep", "tpumon.sweep.collect"}
    assert names.count("tpumon.sweep") == names.count("tpumon.sweep.collect")
    assert not S.mirroring
    # after the session, none again
    with rec.root("sweep") as root:
        assert root.rf is None


def test_a_session_the_engine_does_not_own_gets_no_ranges():
    from torch.profiler import ProfilerActivity, profile

    rec = S.Recorder()
    with T.profiler_session():
        assert not S.mirroring
        prof = profile(activities=[ProfilerActivity.CPU])
        prof.start()
        try:
            with rec.root("sweep"):
                with S.span("collect") as sp:
                    assert sp.rf is None
                    torch.ones(4).add_(1.0)
        finally:
            prof.stop()
    events = list(prof.profiler.kineto_results.events())
    assert any(e.name() == "aten::add_" for e in events)
    assert _user_ranges(events) == []
    assert rec.aggregates()["sweep.collect"][0] == 1


class _Event:
    """The part of a ``KinetoEvent`` the engine's parse reads."""

    def __init__(self, name, start, dur, dev=False, corr=0, linked=0,
                 flops=0):
        self._name, self._start, self._dur = name, start, dur
        self._dev, self._corr, self._linked = dev, corr, linked
        self._flops = flops

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._dev else DeviceType.CPU

    def device_index(self):
        return 1

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._linked

    def start_thread_id(self):
        return 1

    def flops(self):
        return self._flops


def _session():
    """Ops that launch kernels, one kernel launched outside any op."""

    return [
        _Event("aten::mm", 100, 50, corr=1, flops=4096),
        _Event("cudaLaunchKernel", 110, 5, corr=900, linked=1),
        _Event("nvjet_tst_x", 200, 40, dev=True, corr=900, linked=1),
        _Event("aten::add", 300, 20, corr=2, flops=16),
        _Event("cudaLaunchKernel", 305, 5, corr=901, linked=2),
        _Event("void elementwise_kernel", 320, 10, dev=True, corr=901,
               linked=2),
        _Event("stream_kernel", 500, 60, dev=True, corr=903),
    ]


def test_span_ranges_leave_the_parse_unchanged():
    """A session's events with the monitor's ranges (host ranges and their
    device extents) read as the same records and the same sample."""

    base = _session()
    with_spans = base + [
        _Event("tpumon.sweep", 0, 700, corr=50),
        _Event("tpumon.sweep.collect.probe", 90, 300, corr=51),
        _Event("tpumon.sweep.collect.probe.drain", 95, 70, corr=52),
        # Kineto's device extent of a range over kernels
        _Event("tpumon.sweep.collect.probe", 200, 640, dev=True, corr=53,
               linked=51),
    ]
    want, got = T.kineto_records(base), T.kineto_records(with_spans)
    assert got == want
    # the same sample, but for the time it was read at
    a, b = (T.analyze(r, 1e-6, {1: H100})[1] for r in (got, want))
    assert dataclasses.replace(a, ts=0.0) == dataclasses.replace(b, ts=0.0)
    assert a.n_ops == 3 and a.duty > 0
