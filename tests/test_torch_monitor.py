"""The port's monitoring half on the CPU: probes, the CUDA backend's field
mapping, the renderer, the exporter sweep, the runner CLI, and the rule
that ``tpumon_torch`` never imports JAX or the JAX package.

The probe tests mirror ``tests/test_probes.py`` through the same timing
seam (``ProbeEngine._time``) on a CPU device; the backend and renderer
tests hold the port against ``tpumon``'s own classes on identical values.
"""

import ast
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from tpumon_torch import fields as TF
from tpumon_torch.backends import LibraryNotFound, make_backend
from tpumon_torch.backends.base import Backend
from tpumon_torch.backends.cuda import CudaBackend, _StepTracker
from tpumon_torch.backends.probes import ProbeEngine, ProbeSample

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F = TF.F
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The runner and the probes' workloads run on every core torch is
    given; two threads keep them from crowding the suite's other
    workers."""

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---- probes (mirror of tests/test_probes.py:22-123) -------------------------

def test_probe_engine_idle_reads_zero_and_caches():
    eng = ProbeEngine(CPU, min_interval_s=60.0)
    s1 = eng.sample()
    # a loaded test box is real contention: bounds only, plus "not pegged"
    for est in (s1.duty_est, s1.mxu_active_est, s1.hbm_active_est):
        assert 0.0 <= est <= 0.9
    assert s1.latency_us > 0
    assert s1.mm_tflops > 0 and s1.stream_gbps > 0
    assert eng.sample() is s1  # within min_interval: no re-probe


def test_probe_nonblocking_warmup():
    eng = ProbeEngine(CPU, min_interval_s=0.0)
    first = eng.sample(wait=False)
    if first is not None:
        assert first.latency_us > 0
        return
    deadline = time.time() + 60
    while eng.sample(wait=False) is None and time.time() < deadline:
        time.sleep(0.05)
    s = eng.sample(wait=False)
    assert s is not None and s.latency_us > 0


def test_abandoned_warmup_bails_without_compiling():
    eng = ProbeEngine(CPU, min_interval_s=0.0)
    eng.abandon()
    t0 = time.time()
    eng.warmup()
    assert time.time() - t0 < 5.0
    assert eng._compiled is False
    assert eng.sample(wait=True) is None
    assert eng.sample(wait=False) is None
    assert eng.baseline() is None
    eng.sample(wait=False)
    assert eng._warmup_thread is None


def test_abandon_mid_calibration(monkeypatch):
    eng = ProbeEngine(CPU, min_interval_s=0.0)
    calls = {"n": 0}
    orig = ProbeEngine._time

    def counting_time(fn, x):
        calls["n"] += 1
        if calls["n"] == 3:
            eng.abandon()
        return orig(fn, x)

    monkeypatch.setattr(ProbeEngine, "_time", staticmethod(counting_time))
    eng.warmup()
    assert eng._compiled is False
    assert calls["n"] <= 4


def test_probe_engine_baseline_exposed():
    base = ProbeEngine(CPU, min_interval_s=60.0).baseline()
    assert base["latency_us"] >= 1.0
    assert base["mm_tflops"] > 0
    assert base["stream_gbps"] > 0


def test_probe_detects_synthetic_queueing(monkeypatch):
    eng = ProbeEngine(CPU, min_interval_s=0.0)
    eng.sample()
    real_time = ProbeEngine._time

    def slow_time(fn, x):
        return real_time(fn, x) + eng._base_latency_us / 1e6 * 50

    monkeypatch.setattr(ProbeEngine, "_time", staticmethod(slow_time))
    assert eng.sample().duty_est > 0.9


def test_probe_estimator_math(monkeypatch):
    """Deadbanded estimators on fixed timings: duty = 1 - 2*base/lat,
    headroom estimates likewise against the calibrated rates."""

    eng = ProbeEngine(CPU, min_interval_s=0.0)
    eng._compiled = True
    eng._tiny = eng._mm_x = eng._stream_x = None
    eng._tiny_fn = eng._mm_fn = eng._stream_fn = None
    eng._mm_flops, eng._stream_bytes = 1e12, 1e9
    eng._base_latency_us, eng._base_mm_tflops = 100.0, 8.0
    eng._base_stream_gbps = 10.0
    times = iter([400e-6, 300e-6, 500e-6, 0.5, 0.2])
    monkeypatch.setattr(ProbeEngine, "_time",
                        staticmethod(lambda fn, x: next(times)))
    s = eng.sample()
    assert s.latency_us == pytest.approx(400.0)  # median of three
    assert s.duty_est == pytest.approx(1 - 2 * 100 / 400)
    assert s.mm_tflops == pytest.approx(2.0)
    assert s.mxu_active_est == pytest.approx(1 - 2 * 2.0 / 8.0)
    assert s.stream_gbps == pytest.approx(5.0)
    assert s.hbm_active_est == 0.0  # 1 - 2*5/10, clamped at 0


def test_probe_sizes_match_reference():
    from tpumon.backends.probes import ProbeEngine as JaxProbeEngine
    for attr in ("MM_N", "MM_CHAIN", "STREAM_MIB", "DEADBAND"):
        assert getattr(ProbeEngine, attr) == getattr(JaxProbeEngine, attr)


def test_step_tracker_ewma():
    t = _StepTracker(alpha=0.5)
    assert t.ewma_us is None
    t.note(now=1.0)
    assert t.ewma_us is None
    t.note(now=1.010)
    assert t.ewma_us == pytest.approx(10_000, rel=1e-6)
    t.note(now=1.030)
    assert t.ewma_us == pytest.approx(15_000, rel=1e-6)


# ---- the CUDA backend ---------------------------------------------------------

def test_cuda_backend_raises_cleanly_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(LibraryNotFound):
        CudaBackend().open()
    import tpumon_torch
    with pytest.raises(LibraryNotFound):
        tpumon_torch.init(backend_name="cuda")


def test_make_backend_knows_only_cuda():
    from tpumon_torch.backends import BackendError
    assert isinstance(make_backend("cuda"), CudaBackend)
    with pytest.raises(BackendError):
        make_backend("pjrt")


MIB = 1024 * 1024
USED, PEAK, TOTAL = 512 * MIB, 1024 * MIB, 16 * 1024 * MIB


class _Props:
    name = "Stub GPU"
    uuid = "0000-stub"
    multi_processor_count = 4


def _stub_cuda(sample_kw=None, probes=True, trace=False):
    b = CudaBackend()
    b._devices = [0]
    b._opened = True
    b._props = {0: _Props()}
    b._probes_enabled = probes
    b._trace_enabled = trace
    b._hbm_stats = lambda idx: {"used": USED, "peak": PEAK, "total": TOTAL}
    if probes:
        sample = ProbeSample(**sample_kw) if sample_kw else None
        b._probe_sample = lambda idx: sample
    return b


def _stub_pjrt(sample_kw=None, probes=True):
    from tpumon.backends.pjrt import PjrtBackend
    from tpumon.backends.probes import ProbeSample as JaxProbeSample

    class StubDev:
        device_kind = "TPU v5 lite"
        id = 0
        platform = "tpu"

        def memory_stats(self):
            return {"bytes_in_use": USED, "peak_bytes_in_use": PEAK,
                    "bytes_limit": TOTAL}

    b = PjrtBackend()
    b._devices = [StubDev()]
    b._client = None
    b._opened = True
    b._probes_enabled = probes
    b._trace_enabled = False
    sample = JaxProbeSample(**sample_kw) if sample_kw else None
    b._probe_sample = lambda idx: sample
    return b


SAMPLE = dict(ts=0.0, latency_us=123.0, mm_tflops=400.0, stream_gbps=2000.0,
              duty_est=0.8, mxu_active_est=0.6, hbm_active_est=0.3)
ALL_FIELDS = (TF.EXPORTER_BASE_FIELDS + TF.EXPORTER_PROFILING_FIELDS +
              TF.EXPORTER_DCN_FIELDS)


@pytest.mark.parametrize("sample_kw", [SAMPLE, None],
                         ids=["probe-sample", "probes-warming"])
def test_read_fields_maps_like_pjrt_without_trace(sample_kw):
    """Same memory and probe sources -> the same value for every field id
    the exporter asks for (identity fields aside), as the JAX backend
    serves them with its trace engine off."""

    ident = {int(F.CHIP_UUID), int(F.CHIP_NAME)}
    fids = [f for f in ALL_FIELDS if f not in ident]
    got = _stub_cuda(sample_kw).read_fields(0, fids)
    want = _stub_pjrt(sample_kw).read_fields(0, fids)
    assert got == want
    assert got[int(F.HBM_USED)] == 512 and got[int(F.HBM_TOTAL)] == 16384
    assert got[int(F.HBM_PEAK_USED)] == 1024


def test_read_fields_identity_and_step_time():
    b = _stub_cuda(SAMPLE)
    vals = b.read_fields(0, [int(F.CHIP_UUID), int(F.CHIP_NAME),
                             int(F.PROF_STEP_TIME)])
    assert vals[int(F.CHIP_UUID)] == "GPU-0000-stub"
    assert vals[int(F.CHIP_NAME)] == "Stub GPU"
    assert vals[int(F.PROF_STEP_TIME)] == 123.0  # probe proxy until steps
    b.note_step()
    time.sleep(0.01)
    b.note_step()
    assert b.read_fields(0, [int(F.PROF_STEP_TIME)])[
        int(F.PROF_STEP_TIME)] >= 5_000


def test_probe_fields_blank_when_probes_disabled():
    vals = _stub_cuda(probes=False).read_fields(
        0, [int(F.HBM_USED), int(F.TENSORCORE_UTIL),
            int(F.PROF_DUTY_CYCLE_1S)])
    assert vals[int(F.HBM_USED)] == 512
    assert vals[int(F.TENSORCORE_UTIL)] is None
    assert vals[int(F.PROF_DUTY_CYCLE_1S)] is None


def test_no_trace_engine_hooks():
    b = _stub_cuda()
    assert b.force_trace_capture() is False
    assert b.trace_cost_stats() is None
    assert b.trace_last_error() is None
    assert b.attribution_stats() is None
    assert b.trace_capture_spans() == []


# ---- the backend's trace half against PjrtBackend's --------------------------

TRACE = dict(window_s=0.25, duty=0.8, busy_s=0.2, mxu_frac=0.6,
             vector_frac=0.15, data_frac=0.02, infeed_stall=0.04,
             outfeed_stall=0.01, collective_stall=0.0, achieved_tflops=412.5,
             mxu_tflops=400.0, peak_tflops=989.0, peak_hbm_gbps=3350.0,
             n_ops=31, exact_categories=True)


def _trace_pair(trace_kw, sample_kw, probes=True):
    """(CudaBackend, PjrtBackend) serving the same trace sample (each its
    own package's TraceSample) and the same probe sample."""

    from tpumon import xplane as X
    from tpumon_torch import trace as T

    ours = _stub_cuda(sample_kw, probes=probes, trace=trace_kw is not None)
    ref = _stub_pjrt(sample_kw, probes=probes)
    ref._trace_enabled = trace_kw is not None
    if trace_kw is not None:
        now = time.monotonic()
        ours._trace_sample = lambda idx: T.TraceSample(ts=now, **trace_kw)
        ours._trace_schedule = lambda idx: None
        ref._trace_sample = lambda idx: X.TraceSample(ts=now, **trace_kw)
    return ours, ref


BUSY_PROBE = dict(SAMPLE, duty_est=0.9, mxu_active_est=0.7)
IDLE_PROBE = dict(SAMPLE, duty_est=0.0, mxu_active_est=0.0)


@pytest.mark.parametrize("trace_kw,sample_kw,probes", [
    (TRACE, SAMPLE, True),
    (TRACE, None, False),
    (dict(TRACE, exact_categories=False, mxu_frac=0.2), SAMPLE, True),
    (dict(TRACE, exact_categories=False, mxu_frac=0.2), BUSY_PROBE, True),
    (dict(TRACE, duty=0.0, busy_s=0.0, mxu_frac=0.0, vector_frac=0.0,
          data_frac=0.0, infeed_stall=0.0, outfeed_stall=0.0,
          achieved_tflops=None, mxu_tflops=None, n_ops=0,
          exact_categories=False), BUSY_PROBE, True),
    (dict(TRACE, duty=0.0, busy_s=0.0, mxu_frac=0.0, vector_frac=0.0,
          data_frac=0.0, infeed_stall=0.0, outfeed_stall=0.0,
          achieved_tflops=None, mxu_tflops=None, n_ops=0,
          exact_categories=False), IDLE_PROBE, True),
    (dict(TRACE, achieved_tflops=None, mxu_tflops=None), SAMPLE, True),
    (dict(TRACE, mxu_frac=0.005), None, False),
    (None, SAMPLE, True),
], ids=["exact", "exact-no-probes", "inexact", "tighter-mxu-bound",
        "empty-trace-busy-probe", "empty-trace-idle-probe", "no-flops",
        "mxu-below-occupancy-floor", "engine-off"])
def test_read_fields_maps_like_pjrt_with_trace(trace_kw, sample_kw, probes):
    """The source rules of ``pjrt.py:531-707`` on one stubbed sample: the
    same value for every field the exporter asks for (identity aside).
    The trace has no HBM rates, as the port's never does, so the HBM
    families stay on the probes."""

    ident = {int(F.CHIP_UUID), int(F.CHIP_NAME)}
    fids = [f for f in ALL_FIELDS if f not in ident]
    ours, ref = _trace_pair(trace_kw, sample_kw, probes)
    got = ours.read_fields(0, fids)
    want = ref.read_fields(0, fids)
    assert got == want
    if trace_kw is TRACE:
        assert got[int(F.PROF_DUTY_CYCLE_1S)] == 0.8      # trace beats probe
        assert got[int(F.PROF_MFU)] == pytest.approx(412.5 / 989.0)
        assert got[int(F.PROF_VECTOR_ACTIVE)] == 0.15


def test_exact_trace_skips_the_probe_unless_a_field_needs_it():
    calls = []
    b = _stub_cuda(SAMPLE, trace=True)
    from tpumon_torch import trace as T
    b._trace_sample = lambda idx: T.TraceSample(ts=time.monotonic(), **TRACE)
    b._trace_schedule = lambda idx: None
    b._probe_sample = lambda idx: calls.append(idx)
    b.note_step()
    b.note_step()
    b.read_fields(0, [int(F.PROF_DUTY_CYCLE_1S), int(F.PROF_STEP_TIME),
                      int(F.PROF_MXU_ACTIVE)])
    assert calls == []
    b.read_fields(0, [int(F.PROF_DUTY_CYCLE_1S), int(F.PROF_HBM_ACTIVE)])
    assert calls == [0]       # the profiler counts no bytes


def test_probe_runs_outside_the_engines_session():
    """A sweep closes an elapsed session, reads the cached sample, probes,
    and only then opens the next session: never a probe under the
    profiler's recording."""

    order = []

    class Engine:
        def peek(self, index):
            order.append("peek")
            return None

        def sample(self, index, wait=False):
            order.append("open")
            return None

    b = _stub_cuda(SAMPLE, trace=True)
    b._trace = Engine()
    b._probe_sample = lambda idx: order.append("probe")
    b.read_fields(0, [int(F.TENSORCORE_UTIL)])
    assert order == ["peek", "probe", "open"]
    order.clear()
    b.read_fields(0, [int(F.HBM_USED)])     # no utilization field asked
    assert order == []


class _StubEngine:
    """The parts of a trace engine the backends' hooks read."""

    def __init__(self, stats=None):
        self._stats = stats or {}
        self.polls = 0
        self.quiesced = False

    def stats(self):
        return dict(self._stats)

    def latest(self):
        return {}

    def poll(self):
        self.polls += 1

    def quiesce(self, timeout_s=5.0):
        self.quiesced = True
        return True

    def capture_spans(self):
        return [(1.0, 2.0)]


STATS = {"captures_ok": 7.0, "captures_failed": 2.0,
         "capture_wall_s": 1.25, "capture_close_s": 0.25,
         "capture_parse_s": 0.5,
         "capture_cost_ewma_s": 0.375, "capture_window_ms": 137.5,
         "effective_interval_s": 18.75, "capturing": 1.0, "disabled": 0.0,
         "sample_age_s": 3.5, "attribution_suspect": 0.0,
         "attribution_consistency": -1.0}


def test_self_metric_lines_byte_identical_to_reference():
    from tpumon.backends.pjrt import PjrtBackend

    ours, ref = _stub_cuda(), PjrtBackend()
    assert ours.self_metric_lines() == [] == ref.self_metric_lines()
    ours._trace, ref._trace = _StubEngine(STATS), _StubEngine(STATS)
    for label in ('host="h1"', ""):
        got = ours.self_metric_lines(label)
        assert got == ref.self_metric_lines(label)
        assert len(got) == 21
    # the reference's counters, and the port's close beside them
    cost, ref_cost = ours.trace_cost_stats(), ref.trace_cost_stats()
    assert {k: cost[k] for k in ref_cost} == ref_cost
    assert set(cost) - set(ref_cost) == {"capture_close_s"}
    assert cost["capture_close_s"] == 0.25
    assert ours.trace_capture_spans() == ref.trace_capture_spans()
    assert ours.attribution_stats() is None


def test_failed_capture_shows_on_the_scrape(monkeypatch):
    """Without CUDA the engine's capture fails; it is counted, never
    carried on on the CPU, and the fields fall back to the probes."""

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    b = _stub_cuda(SAMPLE, trace=True)
    vals = b.read_fields(0, [int(F.PROF_DUTY_CYCLE_1S),
                             int(F.PROF_VECTOR_ACTIVE)])
    assert vals[int(F.PROF_DUTY_CYCLE_1S)] == 0.8   # the probe's
    assert vals[int(F.PROF_VECTOR_ACTIVE)] is None
    assert b._trace.quiesce(5.0)
    assert b.trace_last_error()  # why the capture was refused
    text = "\n".join(b.self_metric_lines('host="h"'))
    assert 'tpumon_trace_capture_failures_total{host="h"} 1.000' in text
    assert 'tpumon_trace_captures_total{host="h"} 0.000' in text


def test_trace_switch_is_the_environment(monkeypatch):
    monkeypatch.delenv("TPUMON_CUDA_TRACE", raising=False)
    assert CudaBackend()._trace_enabled is True
    monkeypatch.setenv("TPUMON_CUDA_TRACE", "0")
    b = CudaBackend()
    assert b._trace_enabled is False
    b._devices, b._opened = [0], True
    assert b._trace_sample(0) is None
    assert b.force_trace_capture() is False
    assert b._trace is None


def test_note_step_and_close_drive_the_engine():
    b = _stub_cuda()
    eng = b._trace = _StubEngine()
    b.note_step()
    b.note_step()
    assert eng.polls == 2
    b.close()
    assert eng.quiesced and b._trace is None


# ---- renderer and exporter ----------------------------------------------------

def _values(step):
    vals = {}
    for i, fid in enumerate(ALL_FIELDS):
        meta = TF.CATALOG[fid]
        if meta.vector_label:
            vals[fid] = [float(i + step), None, 2.5]
        elif i % 5 == 0:
            vals[fid] = None
        elif i % 3 == 0:
            vals[fid] = (i * 7 + step) % 11
        else:
            vals[fid] = 0.125 * i + step
    return vals


def test_renderer_bytes_identical_to_reference():
    from tpumon.exporter import promtext as JP
    from tpumon_torch.exporter import promtext as TP

    labels = {c: {"chip": str(c), "uuid": f"GPU-{c}", "model": 'H"100'}
              for c in range(2)}
    ours, ref = TP.SweepRenderer(ALL_FIELDS), JP.SweepRenderer(ALL_FIELDS)
    for step in range(3):  # the second and third sweeps hit the line cache
        per_chip = {c: _values(step + c) for c in range(2)}
        extra = TP.render_family("tpumon_x", "gauge", "x.", 'host="h"', 1.5)
        got = ours.compose(ours.render_parts(per_chip, labels), extra)
        want = ref.compose(ref.render_parts(per_chip, labels), extra)
        assert got == want
        assert ours.render(per_chip, labels) == ref.render(per_chip, labels)


def _stub_backend(base, types, values):
    class Stub(base):
        name = "stub"

        def open(self):
            pass

        def close(self):
            pass

        def chip_count(self):
            return 2

        def chip_info(self, index):
            return types.ChipInfo(index=index, uuid=f"GPU-{index}",
                                  name="Stub GPU",
                                  arch=types.ChipArch.UNKNOWN)

        def versions(self):
            return types.VersionInfo()

        def read_fields(self, index, field_ids, now=None):
            return {f: values[index].get(int(f)) for f in field_ids}

    return Stub()


def test_exporter_families_match_reference_exporter():
    """The port's sweep core renders the same ``tpu_*`` families as the
    reference exporter over a backend serving the same values."""

    import tpumon
    import tpumon_torch
    from tpumon import types as JT
    from tpumon.backends.base import Backend as JaxBackend
    from tpumon.exporter.exporter import TpuExporter as JaxExporter
    from tpumon_torch import types as TT
    from tpumon_torch.exporter.exporter import TpuExporter

    values = {c: _values(c) for c in range(2)}
    # chip 0 lacks field 208: the exporter synthesizes it from the duty
    # (busy in the first sweep, idle after), as the reference does
    values[0][int(F.NOT_IDLE_TIME)] = None
    values[0][int(F.TENSORCORE_UTIL)] = 40
    ours = TpuExporter(tpumon_torch.Handle(_stub_backend(Backend, TT, values)),
                       profiling=True, dcn=True, output_path=None)
    ref = JaxExporter(tpumon.Handle(_stub_backend(JaxBackend, JT, values)),
                      profiling=True, dcn=True, output_path=None)

    def chip_lines(text):
        return [ln for ln in text.splitlines()
                if ln.lstrip("# HELPTY").startswith("tpu_")]

    for now in (1000.0, 1001.0, 1004.0):
        got, want = ours.sweep(now=now), ref.sweep(now=now)
        assert chip_lines(got) == chip_lines(want)
        assert chip_lines(got)
        values[0][int(F.TENSORCORE_UTIL)] = 0
    lines = got.splitlines()
    assert any(ln.startswith('tpu_last_not_idle_time{chip="0"')
               and ln.endswith(" 4") for ln in lines)  # idle since 1000
    assert any(ln.startswith("tpumon_exporter_sweeps_total{")
               and ln.endswith(" 2") for ln in lines)


def test_exporter_refuses_unported_planes(tmp_path):
    """Nothing of the reference exporter's planes is refused any more: the
    modeled per-link split (ROADMAP.md item 7) runs over a backend without
    topology and splits nothing.  The burst, recorder and anomaly planes
    run (their byte-for-byte cases are in ``tests/test_torch_exporter.py``),
    and so do the stream plane (``tests/test_torch_stream.py``), the
    textfile merge, the enricher and pod attribution; ``anomaly_kmsg``
    without rules takes no line."""

    import tpumon_torch
    from tpumon_torch import types as TT
    from tpumon_torch.anomaly import Rules
    from tpumon_torch.exporter.exporter import TpuExporter

    h = tpumon_torch.Handle(_stub_backend(
        Backend, TT, {c: _values(c) for c in range(2)}))
    modeled = TpuExporter(h, output_path=None, ici_per_link_modeled=True)
    try:
        assert 'source="modeled"' not in modeled.sweep()
    finally:
        modeled.stop()
    rules = Rules.from_dict({"version": 1, "detectors": [
        {"name": "any", "field": 203, "type": "threshold", "above": -1}]})
    planes = TpuExporter(h, output_path=None, burst_hz=50,
                         blackbox_dir=str(tmp_path / "bb"), rules=rules)
    try:
        assert planes.anomaly_kmsg("x", 0.0) is True
        text = planes.sweep()
    finally:
        planes.stop()
    assert "tpumon_blackbox_frames_total" in text
    assert "tpumon_anomaly_findings_total" in text
    (tmp_path / "drop.prom").write_text('tpu_workload_x{chip="0"} 7\n')
    exp = TpuExporter(h, output_path=str(tmp_path / "x.prom"),
                      merge_globs=[str(tmp_path / "drop.prom")])
    exp.set_stream_publisher(None)  # installs, as in the reference
    assert exp.anomaly_kmsg("x", 0.0) is False
    exp.set_enricher(lambda text: text + "# enriched\n")
    text = exp.sweep()
    assert text.startswith("# HELP") and "# enriched" in text
    assert 'tpu_workload_x{chip="0"} 7' in text
    exp.set_enricher(None)

    class Attributor:
        def device_map(self):
            return {"GPU-1": "pod"}

        def lookup(self, mapping, uuid, chip):
            from tpumon_torch.exporter.podresources import PodInfo
            return PodInfo("p", "n", "c") if uuid in mapping else None

    exp.set_pod_attributor(Attributor())
    exp.sweep()
    lines = (tmp_path / "x.prom").read_text().splitlines()
    assert any('chip="1"' in ln and 'pod_name="p"' in ln for ln in lines)
    assert not any('chip="0"' in ln and "pod_name" in ln for ln in lines)


def test_monitor_cost_matches_reference_arithmetic():
    """The runner's ``monitor_cost`` on scripted cost counters and capture
    spans, against the arithmetic of ``tpumon/loadgen/run.py:345-388``."""

    from tpumon.loadgen.run import capture_step_cost as ref_cost
    from tpumon_torch.loadgen.run import monitor_cost

    blocks = [(i * 0.5, (i + 1) * 0.5, 12 + (i % 4)) for i in range(40)]
    spans = [(2.0, 4.5), (9.1, 12.0), (30.0, 31.0)]
    cases = [({}, {}),
             (dict(STATS, captures_ok=2.0, captures_failed=0.0,
                   capture_wall_s=0.25, capture_parse_s=0.125,
                   capturing=0.0), STATS),
             (dict(STATS, capturing=1.0), dict(STATS, capture_cost_ewma_s=-1.0,
                                               capture_window_ms=0.0))]
    for cost0, cost1 in cases:
        sweep_s, elapsed, t0 = 0.4321, 20.0, 0.0
        got = monitor_cost(cost0, cost1, sweep_s, elapsed, blocks, spans, t0)
        want = {
            "sweep_s": round(sweep_s, 3),
            "sweep_pct_of_window": round(100.0 * sweep_s /
                                         max(elapsed, 1e-9), 2),
            "captures_in_window": int(
                cost1.get("captures_ok", 0.0) + cost1.get(
                    "captures_failed", 0.0) -
                cost0.get("captures_ok", 0.0) - cost0.get(
                    "captures_failed", 0.0)),
            "capture_wall_s": round(
                cost1.get("capture_wall_s", 0.0) -
                cost0.get("capture_wall_s", 0.0), 3),
            "capture_parse_s": round(
                cost1.get("capture_parse_s", 0.0) -
                cost0.get("capture_parse_s", 0.0), 3),
            "steady_capture_duty_pct": (round(
                100.0 * cost1["capture_cost_ewma_s"] /
                cost1["effective_interval_s"], 2)
                if cost1.get("capture_cost_ewma_s", -1.0) > 0 and
                cost1.get("effective_interval_s", 0.0) > 0 else None),
            "capture_window_ms": round(
                cost1.get("capture_window_ms", 0.0), 1) or None,
            "capture_inflight_at_window_start":
                bool(cost0.get("capturing")),
        }
        want["capture_step_cost_pct"], want["capture_overlap_s"] = ref_cost(
            blocks, spans, t0, t0 + elapsed)
        assert got == want
    assert got["capture_step_cost_pct"] is not None


def test_capture_step_cost_matches_reference():
    from tpumon.loadgen.run import capture_step_cost as ref
    from tpumon_torch.loadgen.run import capture_step_cost as ours
    blocks = [(i * 0.5, (i + 1) * 0.5, 10 + (i % 3)) for i in range(40)]
    spans = [(2.0, 4.2), (9.1, 12.0)]
    for window in ((0.0, 20.0), (3.0, 3.4), (0.0, 1.0)):
        assert ours(blocks, spans, *window) == ref(blocks, spans, *window)


# ---- the runner and the import rule --------------------------------------------

def test_runner_cli_on_cpu():
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", "tpumon_torch.loadgen.run", "--device", "cpu",
         "--size", "tiny", "--seconds", "0.5", "--json"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr
    d = json.loads(r.stdout.strip().splitlines()[-1])
    assert d["pattern"] == "train" and d["steps"] >= 1
    assert d["device"] == "cpu" and d["final_loss"] > 0


@pytest.mark.parametrize("pattern", ["ringattn", "allreduce", "dcn", "pp",
                                     "moe"])
def test_runner_refuses_unported_patterns(capsys, pattern):
    """No pattern is refused any more: each multi-device one runs in a
    1-rank gloo group in this process (the group torn down after)."""

    import torch.distributed as dist

    from tpumon_torch.loadgen import run
    assert run.main(["--pattern", pattern, "--device", "cpu", "--seconds",
                     "0.05", "--json"]) == 0
    d = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert d["pattern"] == pattern and d["steps"] >= 1
    assert not dist.is_initialized()


def test_runner_never_falls_back_to_cpu(monkeypatch):
    from tpumon_torch.loadgen import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run.main(["--size", "tiny", "--seconds", "0.1"])


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, files in os.walk(os.path.join(REPO, "tpumon_torch")):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _const_str(node):
    return node.value if (isinstance(node, ast.Constant)
                          and isinstance(node.value, str)) else ""


def _reference_module(name: str) -> bool:
    """A dotted name that is a module of the JAX package (``tpumon.cli.relay``;
    not a record name such as ``tpumon.grad_sync``)."""

    parts = name.split(".")
    if not all(p.isidentifier() for p in parts):
        return False
    base = os.path.join(REPO, *parts)
    return os.path.isfile(base + ".py") or os.path.isfile(
        os.path.join(base, "__init__.py"))


def test_port_imports_neither_jax_nor_tpumon():
    files = _port_files()
    assert len(files) > 15
    # the out-of-band source and the host surfaces are among them
    for mod in ("backends/nvml.py", "kmsg.py", "procscan.py", "evidence.py",
                "device.py", "process_info.py", "cli/common.py",
                "cli/dmon.py", "cli/deviceinfo.py", "cli/topology.py",
                "cli/processinfo.py", "cli/diag.py", "loadgen/graph.py",
                "loadgen/bench_gpu.py", "wire.py", "httputil.py",
                "exporter/main.py", "exporter/grpc_min.py",
                "exporter/podresources.py", "exporter/pod_attrib.py",
                "exporter/pod_main.py", "sweepframe.py", "burst.py",
                "blackbox.py", "anomaly.py", "simple_yaml.py",
                "cli/replay.py", "fleetpoll.py", "fleetshard.py",
                "supervisor.py", "cli/fleet.py", "agentsim.py", "chaos.py",
                "cli/chaos.py"):
        assert os.path.join(REPO, "tpumon_torch", mod) in files, mod
    bad = []
    for path in files:
        with open(path, encoding="utf-8") as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            # a child started by module path: ``-m tpumon.x`` in an argv
            # list runs the JAX package's module, whatever was imported
            if isinstance(node, (ast.List, ast.Tuple)):
                for a, b in zip(node.elts, node.elts[1:]):
                    if (_const_str(a) == "-m"
                            and _const_str(b).startswith("tpumon.")):
                        bad.append(f"{os.path.relpath(path, REPO)}: "
                                   f"-m {_const_str(b)}")
            elif (_const_str(node) or "").startswith("tpumon.") and \
                    _reference_module(_const_str(node)):
                bad.append(f"{os.path.relpath(path, REPO)}: "
                           f"{_const_str(node)!r}")
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "tpumon",
                                          "bench"):
                    bad.append(f"{os.path.relpath(path, REPO)}: {name}")
    assert bad == []
