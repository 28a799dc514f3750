"""tpumon-diag: active diagnostic of the monitoring stack on this host.

The port's copy of ``tpumon/cli/diag.py`` (``python -m
tpumon_torch.cli.diag``), over the NVML backend by default.  The load of
``--evidence-load`` is the reference's 8-deep chain of 512x512 bf16
products, in torch, on ``cuda`` unless ``--device cpu``.  The event-path
check injects a CHIP_RESET where the backend has an injection hook;
neither port backend has one, so it reports the reference's SKIP.

The ``dcgmi diag`` role — absent from the reference repo (it ships no
diagnostic tool; operators had to infer stack health from missing
metrics) — as a first-party CLI: walk the monitoring pipeline from
backend bring-up to the event path and report PASS/FAIL/SKIP per check,
exit nonzero on any FAIL.  Levels mirror dcgmi's quick/medium/long
split:

* ``-r 1`` (default) — passive: backend init, chip inventory sanity,
  a full status-field read per chip (blank-rate report), versions,
  topology.
* ``-r 2`` — adds stateful subsystems: watch round trip (create →
  sync sweep → latest), health set/check per chip, engine introspection.
* ``-r 3`` — adds the active event path: inject a synthetic event
  (backends that allow it: fake, agent --allow-inject) and verify it
  arrives through the policy violation stream — the end-to-end path a
  real CHIP_RESET would take.  On backends without injection the check
  SKIPs rather than fabricating a fault on production hardware.

Usage:
    python -m tpumon_torch.cli.diag              # NVML backend, level 1
    python -m tpumon_torch.cli.diag -r 2 --json
    python -m tpumon_torch.cli.diag --evidence --evidence-load 10
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from typing import (Any, Callable, List, Optional, Sequence,
                    Tuple)

import tpumon_torch
from tpumon_torch import fields as FF
from .common import add_connection_flags, init_from_args

PASS, FAIL, SKIP = "PASS", "FAIL", "SKIP"


class _EvidenceLoad:
    """Background load for ``--evidence-load``: step a small matmul
    chain on the device so the family-provenance snapshot shows it UNDER
    LOAD (idle leaves the utilization families legitimately blank); on
    the in-process backend, also warm the monitor's probes and force one
    trace capture mid-load.

    Stepping runs UNTIL ``stop()`` (the caller renders the report and
    then stops), so the snapshot is always taken while the chip steps
    — a fixed window could expire during a slow forced capture and
    hand the report an idle chip again.  ``seconds`` is only the
    runaway safety cap.  Deliberately a self-contained mini-loop
    rather than a dependency on :mod:`tpumon_torch.loadgen`: the diag
    CLI needs ~15 lines of load, not a model zoo."""

    def __init__(self, h: "tpumon_torch.Handle", seconds: float,
                 device: str = "cuda") -> None:
        self._h = h
        self._device = device
        self._cap_s = min(max(seconds, 1.0), 300.0)
        self._stop = False
        self._thread: Optional[threading.Thread] = None

    def _make_workload(self) -> Tuple[Any, Any, Any]:
        """(step, x0, sync) — the matmul chain.  A seam so the thread
        lifecycle (start/stop/join) is testable without a GPU."""

        import torch

        def _chain(x: Any) -> Any:
            for _ in range(8):
                x = torch.matmul(x, x) / 32.0
            return x

        def sync(x: Any) -> None:
            x.reshape(-1)[0].item()

        x = torch.ones((512, 512), dtype=torch.bfloat16,
                       device=self._device)
        x = _chain(x)        # warm outside the stepping
        sync(x)
        return _chain, x, sync

    def start(self) -> None:
        step, x, sync = self._make_workload()

        def run() -> None:
            n = 0
            t0 = time.monotonic()
            y = x
            while (not self._stop and
                   time.monotonic() - t0 < self._cap_s):
                y = step(y)
                n += 1
                note = getattr(self._h.backend, "note_step", None)
                if callable(note):
                    note()
                if n % 32 == 0:
                    sync(y)
            sync(y)

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="tpumon-diag-load")
        self._thread.start()
        try:
            warm = getattr(self._h.backend, "warmup_probes", None)
            if callable(warm):
                warm(0)
            # one fresh capture while the load runs: the trace-derived
            # families need a sample, not whichever periodic capture
            # might have landed
            force = getattr(self._h.backend, "force_trace_capture", None)
            if callable(force):
                force(timeout_s=30.0)
        except Exception:
            # a failed warmup/capture must not leave the stepping
            # thread alive past this frame — at interpreter exit it
            # would race the runtime teardown and abort
            self.stop()
            raise

    def stop(self) -> None:
        """Bounded join of the stepping thread (idempotent — joining
        a finished thread is a no-op): the report renders first, then
        stop() guarantees no stepping thread survives into
        interpreter/runtime teardown."""

        self._stop = True
        if self._thread is not None:
            self._thread.join(timeout=30.0)


class Report:
    def __init__(self) -> None:
        self.rows: List[Tuple[str, str, str]] = []

    def add(self, name: str, status: str, detail: str = "") -> None:
        self.rows.append((name, status, detail))

    def run(self, name: str,
            fn: Callable[[], Optional[str]]) -> None:
        """Execute one check; an exception is a FAIL with the error as
        detail, never an abort — later checks still run."""

        try:
            out = fn()
            self.add(name, PASS, out or "")
        except _Skip as s:
            self.add(name, SKIP, str(s))
        except Exception as e:  # noqa: BLE001 — the point of a diag
            self.add(name, FAIL, repr(e))

    @property
    def failed(self) -> bool:
        return any(st == FAIL for _, st, _ in self.rows)


class _Skip(Exception):
    pass


def _check_inventory(h: "tpumon_torch.Handle") -> str:
    n = h.chip_count()
    if n < 1:
        raise RuntimeError("no chips visible")
    for c in h.supported_chips():
        info = h.chip_info(c)
        if not info.uuid:
            raise RuntimeError(f"chip {c}: empty uuid")
        if info.hbm.total is not None and info.hbm.total <= 0:
            raise RuntimeError(f"chip {c}: nonpositive HBM total")
    return f"{n} chip(s), uuids ok"


def _check_status_fields(h: "tpumon_torch.Handle") -> str:
    chips = h.supported_chips()
    if not chips:
        raise RuntimeError("no chips to read status fields from")
    fids = [int(f) for f in FF.STATUS_FIELDS]
    worst = (chips[0], -1)
    for c in chips:
        vals = h.backend.read_fields(c, fids)
        blanks = sum(1 for v in vals.values() if v is None)
        if blanks > worst[1]:
            worst = (c, blanks)
    c, blanks = worst
    total = len(fids)
    if blanks == total:
        raise RuntimeError(f"chip {c}: every status field blank "
                           f"(source serving nothing)")
    return f"{total - blanks}/{total} status fields live (worst chip {c})"


def _check_versions(h: "tpumon_torch.Handle") -> str:
    v = h.versions()
    if not (v.runtime or v.driver or v.framework):
        raise RuntimeError("no version information at all")
    return v.runtime or v.driver or v.framework


def _check_topology(h: "tpumon_torch.Handle") -> str:
    t = h.topology(0)
    n = h.chip_count()
    if n > 1 and len(t.links) != n - 1:
        raise RuntimeError(f"{len(t.links)} links for {n} chips")
    return f"mesh {t.mesh_shape or '-'}, {len(t.links)} link(s)"


def _check_watch_roundtrip(h: "tpumon_torch.Handle") -> str:
    fids = [int(FF.F.POWER_USAGE), int(FF.F.HBM_USED)]
    fg = h.watches.create_field_group(fids, "diag")
    cg = h.watches.create_chip_group(h.supported_chips(), "diag")
    h.watches.watch_fields(cg, fg, update_freq_us=100_000,
                           max_keep_samples=4)
    h.watches.update_all(wait=True)
    vals = h.watches.latest_values(0, fids)
    live = sum(1 for v in vals.values() if v is not None)
    if live == 0:
        raise RuntimeError("watch sweep produced no values")
    return f"{live}/{len(fids)} watched fields live"


def _check_health(h: "tpumon_torch.Handle") -> str:
    worst = "PASS"
    for c in h.supported_chips():
        h.health_set(c)
        r = h.health_check(c)
        name = getattr(r.status, "name", str(r.status))
        if name == "FAIL":
            raise RuntimeError(
                f"chip {c} health FAIL: "
                f"{[i.message for i in r.incidents][:3]}")
        if name == "WARN":
            worst = "WARN"
    return f"all chips {worst}"


def _check_introspect(h: "tpumon_torch.Handle") -> str:
    st = h.introspect()
    if st.memory_kb <= 0:
        raise RuntimeError("introspection reports no memory")
    return f"rss {st.memory_kb:.0f} kB, cpu {st.cpu_percent:.1f}%"


def _check_event_path(h: "tpumon_torch.Handle") -> str:
    import queue as _q

    from tpumon_torch.events import EventType, PolicyCondition

    q = h.register_policy(0, PolicyCondition.CHIP_RESET)
    inject = getattr(h.backend, "inject_event", None)
    if callable(inject):
        inject(EventType.CHIP_RESET, chip_index=0,
               message="diag self-test")
    else:
        # the port's backends have no hook (its agent, the reference's
        # other route, is ROADMAP.md, Queue 1, item 16b, part 5)
        raise _Skip("backend has no injection hook "
                    "(real hardware: events come from kmsg/vendor)")
    # the watch pump carries events into the policy engine
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        h.watches.update_all(wait=True)
        try:
            v = q.get(timeout=0.2)
            return f"injected CHIP_RESET delivered ({v.condition.name})"
        except _q.Empty:
            continue
    raise RuntimeError("injected event never reached the policy stream")


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="tpumon-diag", description=__doc__)
    add_connection_flags(p)
    p.add_argument("-r", "--level", type=int, choices=(1, 2, 3), default=1,
                   help="diagnostic depth (1 passive, 2 stateful, "
                        "3 active event path)")
    p.add_argument("--json", action="store_true",
                   help="one JSON object per check on stdout")
    p.add_argument("--evidence", action="store_true",
                   help="print the host's evidence report (one JSON "
                        "document): /dev/nvidia* nodes, the NVIDIA PCI "
                        "devices' sysfs identity, the driver version, "
                        "NVML presence, per-family live/blank "
                        "provenance, an NVLink counter scan")
    p.add_argument("--evidence-load", type=float, default=0.0,
                   metavar="SECONDS",
                   help="with --evidence: step a small matmul chain on "
                        "the device while collecting (up to SECONDS as "
                        "a safety cap), so the per-family provenance "
                        "shows the LOADED device")
    p.add_argument("--device", default="cuda",
                   help="device of the --evidence-load chain (default "
                        "cuda; cpu for a host without a GPU)")
    args = p.parse_args(argv)

    if args.evidence:
        from tpumon_torch import evidence
        try:
            h = init_from_args(args)
        except tpumon_torch.BackendError:
            # a CPU-only host still yields kernel/library/scan evidence;
            # absence of a backend is itself a finding
            h = None
        load = None
        try:
            if args.evidence_load > 0 and h is not None:
                load = _EvidenceLoad(h, args.evidence_load, args.device)
                load.start()
            print(evidence.render(h))
            sys.stdout.flush()
        finally:
            if load is not None:
                load.stop()
            if h is not None:
                tpumon_torch.shutdown()
        return 0

    rep = Report()
    try:
        h = init_from_args(args)
    except tpumon_torch.BackendError as e:
        rep.add("backend init", FAIL, str(e))
        _emit(rep, args.json)
        return 1
    try:
        rep.add("backend init", PASS, h.backend.name)
        rep.run("chip inventory", lambda: _check_inventory(h))
        rep.run("status fields", lambda: _check_status_fields(h))
        rep.run("versions", lambda: _check_versions(h))
        rep.run("topology", lambda: _check_topology(h))
        if args.level >= 2:
            rep.run("watch round trip", lambda: _check_watch_roundtrip(h))
            rep.run("health subsystems", lambda: _check_health(h))
            rep.run("introspection", lambda: _check_introspect(h))
        if args.level >= 3:
            rep.run("event path", lambda: _check_event_path(h))
    finally:
        tpumon_torch.shutdown()
    _emit(rep, args.json)
    return 1 if rep.failed else 0


def _emit(rep: Report, as_json: bool) -> None:
    if as_json:
        for name, status, detail in rep.rows:
            print(json.dumps({"check": name, "status": status,
                              "detail": detail}))
        return
    width = max(len(n) for n, _, _ in rep.rows)
    for name, status, detail in rep.rows:
        tail = f"  {detail}" if detail else ""
        print(f"{name.ljust(width)}  [{status}]{tail}")
    n_fail = sum(1 for _, st, _ in rep.rows if st == FAIL)
    n_skip = sum(1 for _, st, _ in rep.rows if st == SKIP)
    print(f"---- {len(rep.rows)} checks: "
          f"{len(rep.rows) - n_fail - n_skip} pass, {n_fail} fail, "
          f"{n_skip} skip")


if __name__ == "__main__":
    sys.exit(main())
