"""The readers of the program's monitor spans on the CPU, each on a
synthetic run: its value, and None where the run lacks its source (a
program without the span or counter, or a node without the process)."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from gpubench import run
from gpubench.metrics import (agent_scrape_collect_p95_ms,
                              agent_scrape_wait_p95_ms, capture_close_ms,
                              embedded_drain_ms, embedded_probe_ms,
                              exporter_scrape_wait_p95_ms)
from gpubench.stats import percentile

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = ("embedded_drain_ms", "embedded_probe_ms", "capture_close_ms",
       "exporter_scrape_wait_p95_ms", "agent_scrape_wait_p95_ms",
       "agent_scrape_collect_p95_ms")


def _run(role="exporter", window=None, trace_cost=None, bodies=()):
    records = [{"ok": True, "body": b} for b in bodies]
    records.append({"ok": False})
    return run.Run(config={"scrape": {"role": role}}, window=window or {},
                   trace_cost=trace_cost, scrapes={"records": records})


def test_gpubench_embedded_span_readers():
    spans = {"sweep": {"count": 51, "mean_ms": 6.5, "p95_ms": 9.0},
             "sweep.collect.probe.drain": {"count": 50, "mean_ms": 4.25,
                                           "p95_ms": 6.0},
             "sweep.collect.probe.rounds": {"count": 50, "mean_ms": 0.5,
                                            "p95_ms": 0.75}}
    r = _run(window={"monitor_spans": spans})
    assert embedded_drain_ms.read(r) == 4.25
    assert embedded_probe_ms.read(r) == 0.5
    # a program without the spans: the window has no such entry
    for window in ({}, {"monitor_spans": {"sweep": spans["sweep"]}}):
        r = _run(window=window)
        assert embedded_drain_ms.read(r) is None
        assert embedded_probe_ms.read(r) is None


def test_gpubench_capture_close_reader():
    cost = {"captures_ok": 3.0, "captures_failed": 1.0,
            "capture_parse_s": 6.0, "capture_close_s": 0.2}
    assert capture_close_ms.read(_run(trace_cost=cost)) == pytest.approx(50.0)
    del cost["capture_close_s"]          # an engine that counts no close
    assert capture_close_ms.read(_run(trace_cost=cost)) is None
    assert capture_close_ms.read(_run(trace_cost=None)) is None
    assert capture_close_ms.read(_run(trace_cost={
        "captures_ok": 0.0, "captures_failed": 0.0,
        "capture_close_s": 0.0})) is None


def _exporter_body(n, wait, payload=0.0001):
    return (f'tpumon_exporter_request_phase_seconds{{host="h",'
            f'phase="wait"}} {wait}\n'
            f'tpumon_exporter_request_phase_seconds{{host="h",'
            f'phase="payload"}} {payload}\n'
            f'tpumon_exporter_requests_total{{host="h"}} {n}\n')


def test_gpubench_exporter_scrape_wait_reader():
    waits = [0.001, 0.002, 0.004, 0.030, 0.0005]
    bodies = [_exporter_body(k + 1, w) for k, w in enumerate(waits)]
    bodies.insert(2, bodies[1])          # the same request twice: once
    r = _run(bodies=bodies)
    assert exporter_scrape_wait_p95_ms.read(r) == pytest.approx(
        percentile([1000.0 * w for w in waits], 95))
    # the agent serves the node: not this plane
    assert exporter_scrape_wait_p95_ms.read(
        _run(role="agent", bodies=bodies)) is None
    # an exporter that serves no request phase
    assert exporter_scrape_wait_p95_ms.read(
        _run(bodies=["tpu_x 1\n"] * 3)) is None


def _agent_body(wait, collect):
    return (f"tpumon_agent_scrape_wait_ms {wait}\n"
            f"tpumon_agent_scrape_collect_ms {collect}\n"
            f"tpumon_agent_scrape_render_ms 1.5\n")


def test_gpubench_agent_scrape_phase_readers():
    pairs = [(0.2, 10.0), (0.3, 12.0), (5.0, 40.0), (0.25, 11.0)]
    r = _run(role="agent", bodies=[_agent_body(*p) for p in pairs])
    assert agent_scrape_wait_p95_ms.read(r) == pytest.approx(
        percentile([w for w, _ in pairs], 95))
    assert agent_scrape_collect_p95_ms.read(r) == pytest.approx(
        percentile([c for _, c in pairs], 95))
    for reader in (agent_scrape_wait_p95_ms, agent_scrape_collect_p95_ms):
        # the exporter serves the node, or the agent serves no phase
        assert reader.read(_run(role="exporter", bodies=[
            _agent_body(*p) for p in pairs])) is None
        assert reader.read(_run(role="agent", bodies=[
            "tpumon_agent_scrape_render_ms 1.5\n"] * 4)) is None


@pytest.mark.parametrize("name", NEW)
def test_gpubench_span_metric_entries(name):
    """Each new metric is declared once, read from the program, and
    named for the cells whose node serves what it reads."""

    (m,) = [m for m in BENCH["per_layer"] if m["name"] == name]
    assert m["source"] == "program_counter" and m["unit"] == "ms"
    assert m["moves"] == "monitored_steps_per_s"
    assert callable(run.reader(name))
    cells = {w["name"]: w for w in BENCH["workloads"]}
    roles = {c["name"]: json.loads((ROOT / c["file"]).read_text())[
        "scrape"]["role"] for c in BENCH["configs"]}
    for cell in m["workloads"]:
        role = roles[cells[cell]["config"]]
        if name.startswith("exporter_"):
            assert role == "exporter"
        if name.startswith("agent_"):
            assert role == "agent"
    # a layer named before is named letter for letter
    layers = {x["layer"] for x in BENCH["per_layer"] if x["name"] not in NEW}
    assert m["layer"] in layers
