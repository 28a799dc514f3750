"""Scripted fault injection with recovery invariants — the incident
scenario corpus made executable.

The port's copy of ``tpumon/chaos.py``.  Every fault path is tested in
isolation elsewhere: reconnect resets delta tables, drop-to-keyframe
resyncs a wedged subscriber, torn-tail recovery survives ``kill -9``.
Real incidents COMPOSE them — an ECC storm lands while a shard child is
being preempted and a dashboard subscriber is wedged.  This module runs
those compositions on a deterministic timeline and asserts that the
system converges:

* a **scenario** (YAML file under ``tests/data/torch_scenarios/``, or a
  plain dict) names a topology (simulated hosts x GPUs, flat /
  in-process shards / supervised shard child processes / a chain of
  relay processes), a tick count, and a list of timed **actions** —
  value faults on the :class:`~tpumon_torch.agentsim.SimAgent` knobs
  (churn, kill-mid-frame, dead agent, dropped connections), kernel-log
  faults (NVIDIA driver Xid lines classified through
  :mod:`tpumon_torch.kmsg` into events, exactly the path a real host
  takes), and process-level faults against the
  :class:`~tpumon_torch.supervisor.ShardSupervisor`'s children and the
  relay chain (SIGKILL/SIGSTOP/SIGCONT, a closed listener, a wedged
  stream subscriber, a SIGKILLed recording fleet process);
* after the last fault the harness asserts **recovery invariants**:
  the system-under-test's per-host view converges back to
  byte-identical with a flat reference poller within K ticks
  (``converge_within``); healthy shards' bytes/tick stay pinned at
  their steady baseline while a sibling dies (isolation); fd and
  thread counts return to the pre-scenario baseline (no leaks); and a
  blackbox replay of the run reproduces the fault window;
* the whole run is recorded as a **fleet-view blackbox trace**
  (synthetic host rows via :func:`tpumon_torch.fleetshard.sample_to_row`,
  injected events, raw kmsg lines) with deterministic timestamps
  (``BASE_TS + tick * interval``), so the trace doubles as a backtest
  fixture for the anomaly plane.

Only the kernel-log faults differ from the reference, because the
port's classifier reads NVIDIA Xid codes, not TPU driver prose:

* ``ecc_storm`` writes Xid 48 lines ("DBE (Double Bit Error) ECC
  Error"), classified ``ECC_DBE``;
* ``ici_flap`` writes one Xid 74 line ("NVLink Error"), classified
  ``ICI_ERROR``;
* ``thermal_throttle`` writes no kernel line, because the driver
  writes none for a thermal slowdown: it raises ``THERMAL`` directly,
  the event the port derives from NVML's thermal-violation counter.

A simulated host's GPU ``c`` sits on PCI bus ``0000:{0x18 + 0x10 c}:00``
(:func:`gpu_bus_id`), and its Xid lines name that bus, so the classifier
resolves the GPU index from the line as it does on a real host.

Scenario files are ordinary YAML, read by
:func:`tpumon_torch.simple_yaml.parse_simple_yaml`.  Host code only: no
``torch``.  ``python -m tpumon_torch.cli.chaos run`` runs the harness.
"""

from __future__ import annotations

import gc
import json
import os
import random
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field as dc_field
from typing import (Any, Callable, Dict, List, Optional, Sequence,
                    Tuple, Union)

from . import fields as FF
from . import log
from .agentsim import AgentFarm, SimAgent, SimSubscriber, SubscriberFarm
from .backends.base import FieldValue
from .blackbox import BlackBoxReader, BlackBoxWriter, KmsgRecord, ReplayTick
from .events import Event, EventType
from .fleetpoll import (FleetPoller, HostSample,
                        create_fleet_poller)
from .fleetshard import (SF_UP, ShardedFleet, partition_targets,
                         sample_to_row)
from .frameserver import StreamHub
from .kmsg import BusKey, bus_key, classify_line
from .simple_yaml import parse_simple_yaml
from .supervisor import (ShardSupervisor, _poll_rc, _popen_wait,
                         spawn_logged_child)

F = FF.F

#: the fleet CLI's sweep field set — scenarios sweep what operators sweep
FLEET_FIELDS: List[int] = [
    int(F.POWER_USAGE), int(F.CORE_TEMP), int(F.TENSORCORE_UTIL),
    int(F.HBM_BW_UTIL), int(F.HBM_USED), int(F.HBM_TOTAL),
    int(F.ICI_LINKS_UP)]

#: deterministic wall-clock origin for recorded traces: replay windows
#: are tick arithmetic, not wall-clock guesswork
BASE_TS = 1_700_000_000.0


def gpu_bus_id(chip: int) -> str:
    """The PCI bus id of a simulated host's GPU ``chip``, as the driver's
    Xid lines print it (the fake NVML's two cards sit on the same buses)."""

    return f"0000:{0x18 + 0x10 * chip:02x}:00"


def load_scenario_file(path: str) -> "Scenario":
    with open(path) as f:
        data = parse_simple_yaml(f.read())
    if not isinstance(data, dict):
        raise ValueError(f"{path}: scenario must be a mapping")
    return Scenario.from_dict(data)


# -- scenario model ------------------------------------------------------------


_KNOWN_ACTIONS = frozenset({
    "set_value", "churn", "ecc_storm", "ici_flap", "thermal_throttle",
    "preempt", "kill_connections", "kill_mid_frame", "close_listener",
    "kill_shard", "stop_shard", "cont_shard", "wedge_subscriber",
    "resume_subscriber", "spawn_recorder", "kill_recorder",
    "kill_relay", "restart_relay", "stop_relay", "cont_relay",
    "partition_relay", "heal_relay",
})

#: actions that target a shard child process (supervise-only)
_SHARD_ACTIONS = frozenset({"kill_shard", "stop_shard", "cont_shard"})

#: actions that target a relay child process (relays-only); partition/
#: heal act on relay 0's upstream listener — the hub endpoint the
#: chain's root dials — because a deeper relay's listener lives inside
#: another process
_RELAY_ACTIONS = frozenset({"kill_relay", "restart_relay",
                            "stop_relay", "cont_relay",
                            "partition_relay", "heal_relay"})


@dataclass
class Scenario:
    """One parsed scenario, in the reference's format
    (``docs/operations.md``)."""

    name: str
    description: str = ""
    seed: int = 0
    hosts: int = 4
    chips: int = 2
    shards: int = 0               # 0 = flat reference topology only
    supervise: bool = False
    subscribers: int = 0
    #: length of a chain of REAL relay processes (``python -m
    #: tpumon_torch.cli.relay``) relaying host 0's stream (hub ->
    #: relay 0 -> ... -> relay N-1); when set, the scenario's
    #: subscribers attach to the LEAF relay with full decoding, so the
    #: relay invariants judge leaf==origin
    relays: int = 0
    ticks: int = 20
    tick_interval_s: float = 0.2
    converge_within: int = 10
    restart_budget: int = 5
    stale_after_s: float = 2.0
    actions: List[Dict[str, Any]] = dc_field(default_factory=list)
    #: invariant toggles
    check_converge: bool = True
    check_isolation: bool = False
    check_no_leaks: bool = True
    check_replay: bool = True
    #: leaf subscribers' decoded snapshots re-match the origin's last
    #: published state within the convergence budget (relays only)
    check_relay_snapshot: bool = False
    #: at least one leaf subscriber SAW staleness (stale-flagged
    #: ticks/heartbeats) during the run — the degraded window was
    #: surfaced, not silent (relays only)
    check_relay_stale: bool = False
    #: replay expectation: fault window [t0, t1] + markers
    expect_window: Optional[Tuple[int, int]] = None
    expect_markers: List[str] = dc_field(default_factory=list)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Scenario":
        topo = dict(data.get("topology") or {})
        inv = dict(data.get("invariants") or {})
        expect = dict(data.get("expect") or {})
        actions = list(data.get("actions") or [])
        for a in actions:
            if not isinstance(a, dict) or "do" not in a or "at" not in a:
                raise ValueError(f"bad action (need at/do): {a!r}")
            if a["do"] not in _KNOWN_ACTIONS:
                raise ValueError(f"unknown action {a['do']!r}")
        window = expect.get("window")
        s = cls(
            name=str(data.get("name") or "unnamed"),
            description=str(data.get("description") or ""),
            seed=int(data.get("seed") or 0),
            hosts=int(topo.get("hosts", 4)),
            chips=int(topo.get("chips", 2)),
            shards=int(topo.get("shards", 0)),
            supervise=bool(topo.get("supervise", False)),
            subscribers=int(topo.get("subscribers", 0)),
            relays=int(topo.get("relays", 0)),
            ticks=int(data.get("ticks", 20)),
            tick_interval_s=float(data.get("tick_interval_s", 0.2)),
            converge_within=int(data.get("converge_within", 10)),
            restart_budget=int(data.get("restart_budget", 5)),
            stale_after_s=float(data.get("stale_after_s", 2.0)),
            actions=actions,
            check_converge=bool(inv.get("converge", True)),
            check_isolation=bool(inv.get("isolation", False)),
            check_no_leaks=bool(inv.get("no_leaks", True)),
            check_replay=bool(inv.get("replay_fault_window", True)),
            check_relay_snapshot=bool(inv.get(
                "relay_snapshot", int(topo.get("relays", 0)) > 0)),
            check_relay_stale=bool(inv.get("relay_stale_seen", False)),
            expect_window=(int(window[0]), int(window[1]))
            if isinstance(window, list) and len(window) == 2 else None,
            expect_markers=[str(m) for m in
                            (expect.get("markers") or [])],
        )
        if s.supervise and not s.shards:
            raise ValueError(f"{s.name}: supervise needs shards > 0")
        if s.relays and not s.subscribers:
            raise ValueError(f"{s.name}: relays need subscribers > 0 "
                             f"(the leaf invariant judges them)")
        for a in s.actions:
            if a["do"] in _RELAY_ACTIONS:
                if not s.relays:
                    raise ValueError(
                        f"{s.name}: relay actions need "
                        f"topology.relays > 0")
                r = int(a.get("relay", 0))
                if not 0 <= r < s.relays:
                    raise ValueError(
                        f"{s.name}: action {a['do']!r} targets relay "
                        f"{r} of {s.relays}")
                if a["do"] in ("partition_relay", "heal_relay") \
                        and r != 0:
                    raise ValueError(
                        f"{s.name}: {a['do']!r} acts on the chain "
                        f"root's upstream (relay must be 0) — deeper "
                        f"relays' listeners live in other processes")
            if a["do"] in _SHARD_ACTIONS:
                if not s.supervise:
                    raise ValueError(
                        f"{s.name}: shard process actions need "
                        f"topology.supervise: true")
                if not 0 <= int(a.get("shard", 0)) < s.shards:
                    raise ValueError(
                        f"{s.name}: action {a['do']!r} targets shard "
                        f"{a.get('shard')} of {s.shards}")
            if "host" in a and not 0 <= int(a["host"]) < s.hosts:
                raise ValueError(f"{s.name}: action {a['do']!r} "
                                 f"targets host {a['host']} of "
                                 f"{s.hosts}")
            if a["do"].endswith("_subscriber") and not \
                    0 <= int(a.get("subscriber", 0)) < s.subscribers:
                raise ValueError(
                    f"{s.name}: action {a['do']!r} targets "
                    f"subscriber {a.get('subscriber')} of "
                    f"{s.subscribers}")
        return s


@dataclass
class ChaosReport:
    """One run's verdict: every invariant, with the evidence beside
    it.  ``ok`` is the AND of the enabled invariant results."""

    scenario: str
    ok: bool
    violations: List[str]
    ticks: int
    fault_end_tick: Optional[int]
    converged_at: Optional[int]
    ticks_to_converge: Optional[int]
    restarts_total: int
    fd_delta: int
    thread_delta: int
    trace_dir: str
    details: Dict[str, Any] = dc_field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        return {
            "scenario": self.scenario, "ok": self.ok,
            "violations": self.violations, "ticks": self.ticks,
            "fault_end_tick": self.fault_end_tick,
            "converged_at": self.converged_at,
            "ticks_to_converge": self.ticks_to_converge,
            "restarts_total": self.restarts_total,
            "fd_delta": self.fd_delta,
            "thread_delta": self.thread_delta,
            "trace_dir": self.trace_dir, "details": self.details,
        }


def samples_equal(ref: Sequence[HostSample],
                  sut: Sequence[HostSample]) -> bool:
    """Byte-identical on UP rows (repr covers value AND type); DOWN
    rows must agree on being down but not on the error prose — two
    pollers legitimately word the same outage differently (their
    backoff clocks differ), and pinning the prose would make the
    differential flake on exactly the rows it exists to check."""

    if len(ref) != len(sut):
        return False
    for a, b in zip(ref, sut):
        if a.up != b.up:
            return False
        if a.up and repr(a) != repr(b):
            return False
        if not a.up and a.address != b.address:
            return False
    return True


def _fd_count() -> int:
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:  # non-procfs platform: leak check degrades
        return 0


# -- the harness ---------------------------------------------------------------


class ChaosHarness:
    """One scenario's live topology: the simulated agent farm, the
    system under test (flat / in-process shards / supervised child
    processes), the flat reference poller, the optional subscriber
    farm, and the fleet-view trace recorder.  Single-threaded driver:
    :meth:`run_tick` applies due actions then polls both planes."""

    def __init__(self, scenario: Scenario, out_dir: str) -> None:
        self.scenario = scenario
        self.out_dir = out_dir
        self.trace_dir = os.path.join(out_dir, "trace")
        self.rng = random.Random(scenario.seed)
        #: every simulated host's GPUs by bus: what a real host's NVML
        #: backend hands the classifier (``Backend.bus_index``)
        self._buses: Dict[BusKey, int] = {}
        for c in range(scenario.chips):
            key = bus_key(gpu_bus_id(c))
            assert key is not None
            self._buses[key] = c
        self.tick = 0
        self.fault_ticks: List[int] = []
        self.eq_ticks: List[bool] = []
        #: address -> bytes/tick history of the SUT's top poller
        self.top_bytes: List[Dict[str, int]] = []
        #: (tick, shard) pairs actions dirtied — isolation judges only
        #: the shards dirtied INSIDE the fault window (a warm-up churn
        #: long before the incident does not excuse a shard from it)
        self.dirty_marks: List[Tuple[int, int]] = []
        self._pending: Dict[int, List[Callable[[], None]]] = {}
        self._events_this_tick: List[Event] = []
        self._saved: Dict[Tuple[int, int, int], FieldValue] = {}
        self.recorder_proc: Optional["subprocess.Popen[bytes]"] = None
        self.recorder_dir = os.path.join(out_dir, "recorder-bb")
        os.makedirs(self.trace_dir, exist_ok=True)
        iv = scenario.tick_interval_s
        # build order: farm -> sut -> reference -> recorder; close()
        # aggregates in reverse, so a mid-build raise leaks nothing
        self.farm = AgentFarm()
        self.sims: List[SimAgent] = []
        self.sut: Optional[Union[ShardedFleet, ShardSupervisor]] = None
        self.ref: Optional[FleetPoller] = None
        self.flat_sut: Optional[FleetPoller] = None
        self.hub: Optional[StreamHub] = None
        self.subfarm: Optional[SubscriberFarm] = None
        self.subs: List[SimSubscriber] = []
        #: relay chain children: {"proc", "argv", "path", "log"}
        self.relays: List[Dict[str, Any]] = []
        self.writer: Optional[BlackBoxWriter] = None
        try:
            for h in range(scenario.hosts):
                sim = SimAgent()
                self._fill(sim, scenario.chips, seed=scenario.seed + h)
                self.sims.append(sim)
            self.addresses = [
                self.farm.add(s, self._socket_path(h))
                for h, s in enumerate(self.sims)]
            self._hub_addr = ""
            if scenario.subscribers or scenario.relays:
                self.hub = StreamHub(self.farm.server)
                self._hub_addr = self.farm.server.add_unix_listener(
                    self.hub)
            self.farm.start()
            backoff = dict(backoff_base_s=iv, backoff_max_s=4.0 * iv)
            if scenario.supervise:
                self.sut = ShardSupervisor(
                    self.addresses, FLEET_FIELDS,
                    shards=scenario.shards,
                    delay_s=max(0.05, iv / 2.0),
                    timeout_s=max(1.0, 5.0 * iv),
                    backoff_base_s=iv, backoff_max_s=4.0 * iv,
                    restart_budget=scenario.restart_budget,
                    budget_window_s=60.0,
                    health_interval_s=max(0.05, iv / 2.0),
                    stale_after_s=scenario.stale_after_s,
                    poller_backoff_base_s=iv,
                    poller_backoff_max_s=4.0 * iv)
                self.sut.start()
            elif scenario.shards:
                self.sut = ShardedFleet(
                    self.addresses, FLEET_FIELDS,
                    shards=scenario.shards,
                    timeout_s=max(1.0, 5.0 * iv), **backoff)
            else:
                # system-under-test goes native when TPUMON_NATIVE
                # selects the engine; the reference below never does
                self.flat_sut = create_fleet_poller(
                    self.addresses, FLEET_FIELDS,
                    timeout_s=max(1.0, 5.0 * iv), **backoff)
            self.ref = FleetPoller(
                self.addresses, FLEET_FIELDS,
                timeout_s=max(1.0, 5.0 * iv),
                client_name="tpumon-chaos-ref",
                stream_hub=self.hub, **backoff)
            for i in range(scenario.relays):
                # a REAL relay process per level, chained off the
                # hub's host-0 stream: hub -> relay 0 -> ... -> leaf
                self.relays.append(self._spawn_relay(i))
            if scenario.subscribers:
                self.subfarm = SubscriberFarm()
                if scenario.relays:
                    # leaf-relay subscribers decode fully: the relay
                    # invariant is leaf snapshot == origin snapshot
                    leaf = f"unix:{self.relays[-1]['path']}"
                    for _ in range(scenario.subscribers):
                        self.subs.append(self.subfarm.add(
                            leaf, stream=self.addresses[0],
                            decode=True))
                else:
                    for k in range(scenario.subscribers):
                        self.subs.append(self.subfarm.add(
                            self._hub_addr,
                            stream=self.addresses[
                                k % len(self.addresses)]))
                self.subfarm.start()
            self.writer = BlackBoxWriter(
                os.path.join(self.trace_dir, "fleetview"),
                host=scenario.name, flush_interval_s=0.0)
            # self-describing trace: the scenario identity rides IN
            # the first segment's event stream (a kmsg record at the
            # timeline origin), so a recorded corpus trace used as a
            # backtest fixture names its own scenario/seed — the
            # mapping no longer lives only in test code
            self.writer.record_kmsg(
                f"tpumon-chaos: scenario={scenario.name} "
                f"seed={scenario.seed} hosts={scenario.hosts} "
                f"chips={scenario.chips} shards={scenario.shards} "
                f"ticks={scenario.ticks} "
                f"tick_interval_s={scenario.tick_interval_s:g}",
                now=BASE_TS)
            #: which shard holds each host index (isolation bookkeeping)
            self.host_shard: Dict[int, int] = {}
            if scenario.shards:
                for si, idxs in enumerate(partition_targets(
                        self.addresses, scenario.shards)):
                    for j in idxs:
                        self.host_shard[j] = si
        except BaseException:
            self.close()
            raise

    # -- setup helpers ---------------------------------------------------------

    def _socket_path(self, host: int) -> str:
        """A socket path whose crc32 hash-partitions host ``h`` into
        shard ``h % shards`` — scenario files can then say "kill the
        shard NOT holding host 1" and mean it on every run (the
        partition is address-hash-stable, but tempfile names are not
        run-stable)."""

        from zlib import crc32

        shards = max(1, self.scenario.shards)
        want = host % shards
        sockdir = os.path.join(self.out_dir, "farm")
        os.makedirs(sockdir, exist_ok=True)
        for k in range(10_000):
            path = os.path.join(sockdir, f"h{host}-{k}.sock")
            if crc32(f"unix:{path}".encode("utf-8")) % shards == want:
                return path
        raise RuntimeError("no partition-stable socket name found")

    def _spawn_relay(self, i: int) -> Dict[str, Any]:
        """Spawn relay ``i`` of the chain as a real relay process
        (``python -m tpumon_torch.cli.relay``) on a run-stable unix
        socket path (the SIGKILL-restart contract: the replacement
        rebinds the same path and the children's ordinary reconnect
        re-attaches)."""

        iv = self.scenario.tick_interval_s
        path = os.path.join(self.out_dir, f"relay-{i}.sock")
        upstream = (self._hub_addr if i == 0
                    else f"unix:{self.relays[i - 1]['path']}")
        argv = [sys.executable, "-m", "tpumon_torch.cli.relay",
                "--connect", upstream,
                "--stream", self.addresses[0],
                "--listen-unix", path,
                "--backoff-base", str(iv),
                "--backoff-max", str(4.0 * iv),
                "--stale-tick-interval", str(max(0.05, iv / 2.0)),
                "--stale-after", str(2.0 * iv),
                "--timeout", "2.0"]
        log_path = os.path.join(self.out_dir, f"relay-{i}.log")
        proc = spawn_logged_child(argv, log_path)
        deadline = time.monotonic() + 10.0
        while not os.path.exists(path) and \
                time.monotonic() < deadline and _poll_rc(proc) is None:
            time.sleep(0.02)
        if not os.path.exists(path):
            raise RuntimeError(f"relay {i} never bound {path} "
                               f"(see {log_path})")
        return {"proc": proc, "argv": argv, "path": path,
                "log": log_path}

    def _respawn_relay(self, i: int) -> None:
        entry = self.relays[i]
        proc = entry.get("proc")
        if proc is not None and _poll_rc(proc) is None:
            try:
                proc.kill()
                _popen_wait(proc, 10.0)
            except (OSError, subprocess.TimeoutExpired) as e:
                log.warning("chaos: relay %d did not die before "
                            "respawn: %r", i, e)
        entry["proc"] = spawn_logged_child(entry["argv"], entry["log"])
        deadline = time.monotonic() + 10.0
        # the CLI unlinks the dead predecessor's socket file and
        # rebinds; wait for the fresh bind so a follow-up action can
        # rely on the endpoint existing
        while time.monotonic() < deadline:
            if os.path.exists(entry["path"]) and \
                    _poll_rc(entry["proc"]) is None:
                break
            time.sleep(0.02)

    def _kill_relays(self) -> None:
        for i, entry in enumerate(self.relays):
            proc = entry.get("proc")
            if proc is None or _poll_rc(proc) is not None:
                continue
            try:
                proc.kill()
                _popen_wait(proc, 10.0)
            except (OSError, subprocess.TimeoutExpired) as e:
                log.warning("chaos: relay %d did not die: %r", i, e)

    def _fill(self, sim: SimAgent, chips: int, seed: int) -> None:
        rng = random.Random(seed)
        sim.values = {
            c: {f: (round(rng.uniform(0.0, 500.0), 3)
                    if (f + c) % 3 else rng.randrange(1, 10_000))
                for f in FLEET_FIELDS} for c in range(chips)}

    # -- action engine ---------------------------------------------------------

    def _now(self) -> float:
        return BASE_TS + self.tick * self.scenario.tick_interval_s

    def _sim(self, spec: Dict[str, Any]) -> Tuple[int, SimAgent]:
        h = int(spec.get("host", 0))
        return h, self.sims[h]

    def _mark_fault(self, tick: int, shard: Optional[int]) -> None:
        self.fault_ticks.append(tick)
        if shard is not None:
            self.dirty_marks.append((tick, shard))

    def _revert_at(self, tick: int, fn: Callable[[], None]) -> None:
        self._pending.setdefault(tick, []).append(fn)

    def _inject_event(self, host: int, etype: EventType, chip: int,
                      message: str) -> None:
        sim = self.sims[host]
        seq = max((e.seq for e in sim.events), default=0) + 1
        ev = Event(etype=etype, timestamp=self._now(), seq=seq,
                   chip_index=chip, message=message)
        sim.events.append(ev)
        self._events_this_tick.append(ev)

    def _inject_kmsg(self, host: int, chip: int, line: str) -> None:
        """One kernel-log line takes the REAL ingestion path: classify
        (:func:`tpumon_torch.kmsg.classify_line`, the host's GPUs by bus
        id) -> event on the host's agent -> piggybacked on its next
        sweep; the raw line is recorded next to the values it explains,
        like KmsgWatcher's recorder sink."""

        classified = classify_line(line, self._buses)
        if classified is not None:
            etype, chip_idx = classified
            self._inject_event(host, etype,
                               chip_idx if chip_idx >= 0 else chip,
                               line)
        if self.writer is not None:
            self.writer.record_kmsg(line, now=self._now())

    def apply_action(self, a: Dict[str, Any]) -> None:
        do = str(a["do"])
        tick = self.tick
        if do == "set_value":
            h, sim = self._sim(a)
            chip = int(a.get("chip", 0))
            fid = _resolve_field(a.get("field", "POWER_USAGE"))
            vals = sim.values.get(chip)
            if vals is not None:
                vals[fid] = a.get("value")
            self._mark_fault(tick, self.host_shard.get(h))
        elif do == "churn":
            n = int(a.get("mutations", 8))
            hosts = a.get("hosts")
            idxs = ([int(x) for x in hosts] if isinstance(hosts, list)
                    else range(len(self.sims)))
            for h in idxs:
                sim = self.sims[h]
                for _ in range(n):
                    chip = self.rng.randrange(self.scenario.chips)
                    vals = sim.values.get(chip)
                    if vals is not None:
                        vals[self.rng.choice(FLEET_FIELDS)] = round(
                            self.rng.uniform(0.0, 1000.0), 3)
                self._mark_fault(tick, self.host_shard.get(h))
        elif do == "ecc_storm":
            h, _sim = self._sim(a)
            chip = int(a.get("chip", 0))
            for k in range(int(a.get("count", 3))):
                self._inject_kmsg(
                    h, chip,
                    f"NVRM: Xid (PCI:{gpu_bus_id(chip)}): 48, "
                    f"pid='<unknown>', name=<unknown>, DBE (Double Bit "
                    f"Error) ECC Error, partition {k}, subpartition 0")
            self._mark_fault(tick, self.host_shard.get(h))
        elif do == "ici_flap":
            h, sim = self._sim(a)
            fid = int(F.ICI_LINKS_UP)
            for chip, vals in sim.values.items():
                if vals is None:
                    continue
                # setdefault: overlapping flaps must keep the FIRST
                # (true pre-fault) value, or the restore re-installs
                # the faulted one
                self._saved.setdefault((h, chip, fid), vals.get(fid))
                vals[fid] = 0
            self._inject_kmsg(h, 0, f"NVRM: Xid (PCI:{gpu_bus_id(0)}): "
                                    f"74, pid='<unknown>', name=<unknown>, "
                                    f"NVLink Error (link down, flap "
                                    f"detected)")
            self._mark_fault(tick, self.host_shard.get(h))
            if a.get("for_ticks"):
                self._revert_at(tick + int(a["for_ticks"]),
                                lambda: self._restore_field(h, fid))
        elif do == "thermal_throttle":
            h, sim = self._sim(a)
            f_temp, f_util = int(F.CORE_TEMP), int(F.TENSORCORE_UTIL)
            for chip, vals in sim.values.items():
                if vals is None:
                    continue
                self._saved.setdefault((h, chip, f_temp),
                                       vals.get(f_temp))
                self._saved.setdefault((h, chip, f_util),
                                       vals.get(f_util))
                vals[f_temp] = int(a.get("temp", 105))
                vals[f_util] = float(a.get("util", 3.0))
            # no kernel line: the driver logs no Xid for a slowdown;
            # the port raises THERMAL from NVML's violation counter
            self._inject_event(h, EventType.THERMAL, 0,
                               "thermal violation counter rising: "
                               "clocks held at the temperature limit")
            self._mark_fault(tick, self.host_shard.get(h))
            if a.get("for_ticks"):
                def _restore(h: int = h) -> None:
                    self._restore_field(h, f_temp)
                    self._restore_field(h, f_util)
                self._revert_at(tick + int(a["for_ticks"]), _restore)
        elif do == "preempt":
            h, sim = self._sim(a)
            sim.dead = True
            self.farm.kill_connections(self.addresses[h])
            self._mark_fault(tick, self.host_shard.get(h))
            if a.get("for_ticks"):
                def _resched(h: int = h) -> None:
                    self.sims[h].dead = False
                    self._mark_fault(self.tick,
                                     self.host_shard.get(h))
                self._revert_at(tick + int(a["for_ticks"]), _resched)
        elif do == "kill_connections":
            h, _sim = self._sim(a)
            self.farm.kill_connections(self.addresses[h])
            self._mark_fault(tick, self.host_shard.get(h))
        elif do == "kill_mid_frame":
            h, sim = self._sim(a)
            sim.kill_mid_frame_once = True
            self._mark_fault(tick, self.host_shard.get(h))
        elif do == "close_listener":
            h, _sim = self._sim(a)
            self.farm.server.close_listener(self.addresses[h])
            self._mark_fault(tick, self.host_shard.get(h))
        elif do in _SHARD_ACTIONS:
            shard = int(a.get("shard", 0))
            assert isinstance(self.sut, ShardSupervisor)
            child = self.sut.children[shard]
            proc = child.proc
            sig = {"kill_shard": signal.SIGKILL,
                   "stop_shard": signal.SIGSTOP,
                   "cont_shard": signal.SIGCONT}[do]
            if proc is not None and _poll_rc(proc) is None:
                try:
                    os.kill(proc.pid, sig)
                except OSError as e:
                    log.warning("chaos: %s shard %d failed: %r",
                                do, shard, e)
            if do != "cont_shard":
                self._mark_fault(tick, shard)
            else:
                self.fault_ticks.append(tick)
        elif do in ("kill_relay", "stop_relay", "cont_relay"):
            r = int(a.get("relay", 0))
            proc = self.relays[r].get("proc")
            sig = {"kill_relay": signal.SIGKILL,
                   "stop_relay": signal.SIGSTOP,
                   "cont_relay": signal.SIGCONT}[do]
            if proc is not None and _poll_rc(proc) is None:
                try:
                    os.kill(proc.pid, sig)
                except OSError as e:
                    log.warning("chaos: %s relay %d failed: %r",
                                do, r, e)
            self.fault_ticks.append(tick)
        elif do == "restart_relay":
            self._respawn_relay(int(a.get("relay", 0)))
            self.fault_ticks.append(tick)
        elif do == "partition_relay":
            # cut the chain root from the origin: the hub endpoint
            # stops accepting AND its live connections drop — redials
            # fail outright until heal_relay rebinds it.  The relay
            # must keep serving its last-known mirror, stale-flagged.
            self.farm.server.close_listener(self._hub_addr)
            self.fault_ticks.append(tick)
        elif do == "heal_relay":
            assert self.hub is not None
            self.farm.server.add_unix_listener(
                self.hub, self._hub_addr[len("unix:"):])
            self.fault_ticks.append(tick)
        elif do == "wedge_subscriber":
            sub = self.subs[int(a.get("subscriber", 0))]
            # stop reading from the next byte on: kernel + server
            # buffers absorb until the publisher drops it to stale
            sub.stall_after_bytes = sub.bytes_in
            self.fault_ticks.append(tick)
        elif do == "resume_subscriber":
            assert self.subfarm is not None
            self.subfarm.resume(self.subs[int(a.get("subscriber", 0))])
            self.fault_ticks.append(tick)
        elif do == "spawn_recorder":
            self.spawn_recorder(delay_s=float(
                a.get("delay_s", self.scenario.tick_interval_s / 2)))
            self.fault_ticks.append(tick)
        elif do == "kill_recorder":
            self.kill_recorder()
            self.fault_ticks.append(tick)

    def _restore_field(self, host: int, fid: int) -> None:
        sim = self.sims[host]
        for chip, vals in sim.values.items():
            if vals is None:
                continue
            key = (host, chip, fid)
            if key in self._saved:
                vals[fid] = self._saved.pop(key)
        self._mark_fault(self.tick, self.host_shard.get(host))

    # -- recording-fleet child (the torn-tail e2e surface) ---------------------

    def spawn_recorder(self, delay_s: float = 0.05) -> None:
        """Spawn a REAL fleet CLI process (``python -m
        tpumon_torch.cli.fleet``) recording every farm host into
        ``recorder-bb/`` — the subject of the SIGKILL-mid-frame
        torn-tail invariant (a genuine ``kill -9``, not a simulated
        truncation)."""

        if self.recorder_proc is not None:
            return
        argv = [sys.executable, "-m", "tpumon_torch.cli.fleet",
                "-d", str(delay_s), "--timeout", "2.0",
                "--blackbox-dir", self.recorder_dir]
        for addr in self.addresses:
            argv += ["--connect", addr]
        self.recorder_proc = spawn_logged_child(
            argv, os.path.join(self.out_dir, "recorder.log"))

    def kill_recorder(self) -> None:
        """SIGKILL the recording fleet process mid-run — no flush, no
        close: whatever the page cache had is what the reader gets."""

        p, self.recorder_proc = self.recorder_proc, None
        if p is None or _poll_rc(p) is not None:
            return
        try:
            p.kill()
            _popen_wait(p, 10.0)
        except (OSError, subprocess.TimeoutExpired) as e:
            log.warning("chaos: recorder did not die: %r", e)

    # -- tick driver -----------------------------------------------------------

    def run_tick(self) -> Tuple[List[HostSample], List[HostSample]]:
        """One timeline step: reverts due this tick, scheduled
        actions, then reference and SUT sweeps (in that fixed order —
        both see identical sim state), trace recording, bookkeeping."""

        t = self.tick
        for fn in self._pending.pop(t, []):
            fn()
        for a in self.scenario.actions:
            if int(a["at"]) == t:
                self.apply_action(a)
        assert self.ref is not None
        ref_samples = self.ref.poll()
        sut = self.sut if self.sut is not None else self.flat_sut
        assert sut is not None
        sut_samples = sut.poll()
        self.eq_ticks.append(samples_equal(ref_samples, sut_samples))
        if self.sut is not None:
            self.top_bytes.append(self.sut.top.per_host_tick_bytes())
        if self.writer is not None:
            rows = {i: sample_to_row(s)
                    for i, s in enumerate(sut_samples)}
            events, self._events_this_tick = self._events_this_tick, []
            self.writer.record_sweep(rows, events or None,
                                     now=self._now())
        self.tick += 1
        return ref_samples, sut_samples

    def shard_addresses(self) -> List[str]:
        if isinstance(self.sut, ShardSupervisor):
            return [c.address for c in self.sut.children]
        if isinstance(self.sut, ShardedFleet):
            return [s.address for s in self.sut.shards]
        return []

    def restarts_total(self) -> int:
        if isinstance(self.sut, ShardSupervisor):
            return sum(c.restarts_total for c in self.sut.children)
        return 0

    def close(self) -> None:
        """Aggregating teardown in reverse build order — one wedged
        component must not leak the rest (the no-leak invariant
        measures THIS path as much as the steady one)."""

        self.kill_recorder()
        self._kill_relays()
        for closer in (
                lambda: self.writer.flush()
                if self.writer is not None else None,
                lambda: self.writer.close()
                if self.writer is not None else None,
                lambda: self.subfarm.close()
                if self.subfarm is not None else None,
                lambda: self.ref.close()
                if self.ref is not None else None,
                lambda: self.sut.close()
                if self.sut is not None else None,
                lambda: self.flat_sut.close()
                if self.flat_sut is not None else None,
                self.farm.close):
            try:
                closer()
            except Exception as e:  # noqa: BLE001 — teardown must
                # aggregate; a raising close here would abort the
                # leak measurement the invariant depends on
                log.warn_every("chaos.close", 30.0,
                               "chaos teardown step failed: %r", e)


def _resolve_field(spec: Any) -> int:
    if isinstance(spec, int):
        return spec
    try:
        return int(F[str(spec)])
    except KeyError:
        raise ValueError(f"unknown field {spec!r}") from None


# -- invariants + runner -------------------------------------------------------


def _check_replay(scenario: Scenario, trace_dir: str,
                  violations: List[str],
                  details: Dict[str, Any]) -> None:
    """Replay the recorded fleet-view trace and require the fault
    window to be IN it: the marked host down, the injected event
    type, the kernel line.  A flight recorder that records the
    incident except for the incident is the failure mode this pins."""

    reader = BlackBoxReader(os.path.join(trace_dir, "fleetview"))
    window = scenario.expect_window
    iv = scenario.tick_interval_s
    lo = BASE_TS + (window[0] - 0.5) * iv if window else None
    hi = BASE_TS + (window[1] + 0.5) * iv if window else None
    found: Dict[str, bool] = {m: False for m in scenario.expect_markers}
    ticks_seen = 0
    for item in reader.replay():
        ts = item.timestamp
        in_window = ((lo is None or ts >= lo)
                     and (hi is None or ts <= hi))
        if isinstance(item, ReplayTick):
            ticks_seen += 1
            if not in_window:
                continue
            for m in scenario.expect_markers:
                if m.startswith("down:"):
                    row = item.snapshot.get(int(m[5:]))
                    if row is not None and row.get(SF_UP) == 0:
                        found[m] = True
                elif m.startswith("event:"):
                    if any(e.etype.name == m[6:] for e in item.events):
                        found[m] = True
        elif isinstance(item, KmsgRecord) and in_window:
            for m in scenario.expect_markers:
                if m.startswith("kmsg:") and m[5:] in item.line:
                    found[m] = True
    details["replay_ticks"] = ticks_seen
    details["replay_torn_segments"] = reader.last_torn_segments
    if ticks_seen < scenario.ticks:
        violations.append(
            f"replay: {ticks_seen} ticks recorded, ran "
            f"{scenario.ticks} — the trace is not the run")
    for m, hit in found.items():
        if not hit:
            violations.append(f"replay: marker {m!r} absent from the "
                              f"fault window")


def _check_isolation(harness: ChaosHarness, scenario: Scenario,
                     violations: List[str],
                     details: Dict[str, Any]) -> None:
    """Healthy shards' bytes/tick pinned at the steady baseline while
    a sibling dies: the fault window's traffic for NON-dirty shard
    endpoints must never exceed what a steady pre-fault tick cost
    (index-only requests + frames are deterministic byte-for-byte, so
    this is an equality-shaped bound, not a tolerance)."""

    if not harness.top_bytes or not harness.fault_ticks:
        return
    # the window under judgment: the scenario's declared fault window
    # when it names one (so an early warm-up churn is not mistaken for
    # the incident), else every tick an action touched
    if scenario.expect_window is not None:
        first_fault, last_fault = scenario.expect_window
    else:
        first_fault = min(harness.fault_ticks)
        last_fault = max(harness.fault_ticks)
    last_fault = min(last_fault, len(harness.top_bytes) - 1)
    if first_fault > last_fault:
        # a window past the recorded run judges nothing — say so
        # instead of crashing on empty slices
        violations.append(
            f"isolation: fault window starts at tick {first_fault} "
            f"but the run recorded {len(harness.top_bytes)} ticks")
        return
    if first_fault < 3:
        violations.append("isolation: scenario leaves no steady "
                          "baseline ticks before the first fault")
        return
    addrs = harness.shard_addresses()
    dirty = {s for t, s in harness.dirty_marks
             if first_fault - 1 <= t <= last_fault}
    healthy = [a for i, a in enumerate(addrs) if i not in dirty]
    if not healthy:
        violations.append("isolation: every shard was dirtied inside "
                          "the fault window — nothing to judge")
        return
    details["dirty_shards"] = sorted(dirty)
    # baseline: the steady ticks right before the first fault (skip
    # tick 0/1 — keyframes); the bound is their MAX per address
    base_lo = max(2, first_fault - 3)
    for a in healthy:
        baseline = max(hb.get(a, 0) for hb in
                       harness.top_bytes[base_lo:first_fault])
        worst = max((hb.get(a, 0), t) for t, hb in
                    enumerate(harness.top_bytes)
                    if first_fault <= t <= last_fault)
        details.setdefault("isolation", {})[a] = {
            "baseline": baseline, "worst_in_window": worst[0]}
        if worst[0] > baseline:
            violations.append(
                f"isolation: healthy shard {a} moved {worst[0]} B at "
                f"tick {worst[1]} vs steady baseline {baseline} B "
                f"during a sibling's fault window")


def _check_relay_live(harness: ChaosHarness, scenario: Scenario,
                      violations: List[str],
                      details: Dict[str, Any]) -> None:
    """The relay differential, judged while the topology is still
    alive (the convergence judge, applied to the stream plane):
    every leaf subscriber's decoded snapshot must re-match the
    ORIGIN's last published state for the relayed host within the
    convergence budget — across whatever the timeline did to the
    chain — and, when the scenario asks, staleness must have been
    VISIBLE at the leaves during the degraded window."""

    assert harness.hub is not None
    pub = harness.hub.publisher(harness.addresses[0])
    cap = pub._capture
    if cap is None:
        violations.append("relay: the origin never published — "
                          "nothing to judge")
        return
    expect = repr(cap[0])
    subs = [s for s in harness.subs if s.decoder is not None]
    budget_s = max(2.0, scenario.converge_within
                   * scenario.tick_interval_s)
    deadline = time.monotonic() + budget_s
    pending = list(subs)
    while pending and time.monotonic() < deadline:
        pending = [s for s in pending
                   if repr(s.last_snapshot) != expect]
        if pending:
            time.sleep(scenario.tick_interval_s / 4.0)
    details["relay_converged"] = len(subs) - len(pending)
    stale_seen = sum(
        1 for s in subs
        if s.decoder is not None and (s.decoder.stale_ticks > 0
                                      or s.decoder.keyframes > 1))
    details["relay_stale_or_resynced_subs"] = stale_seen
    details["relay_leaf_keyframes"] = [
        s.decoder.keyframes for s in subs if s.decoder is not None]
    if scenario.check_relay_snapshot:
        for s in pending:
            violations.append(
                f"relay: a leaf subscriber's decoded snapshot never "
                f"re-matched the origin within {budget_s:.1f}s "
                f"(ticks={s.ticks}, keyframes="
                f"{s.decoder.keyframes if s.decoder else 0})")
    if scenario.check_relay_stale:
        stale_only = sum(1 for s in subs
                         if s.decoder is not None
                         and s.decoder.stale_ticks > 0)
        details["relay_stale_subs"] = stale_only
        if stale_only == 0:
            violations.append(
                "relay: no leaf subscriber ever saw a stale-flagged "
                "tick — the degraded window was silent")


def run_scenario(scenario: Scenario, out_dir: str) -> ChaosReport:
    """Execute one scenario end to end and judge every enabled
    invariant.  The returned report is also written to
    ``<out_dir>/report.json`` next to the recorded trace."""

    os.makedirs(out_dir, exist_ok=True)
    gc.collect()
    fd_before = _fd_count()
    threads_before = threading.active_count()
    harness = ChaosHarness(scenario, out_dir)
    violations: List[str] = []
    details: Dict[str, Any] = {}
    try:
        for _ in range(scenario.ticks):
            harness.run_tick()
            time.sleep(scenario.tick_interval_s)
        if scenario.relays:
            # judged BEFORE teardown: the leaf subscribers must still
            # be attached for the live differential to mean anything
            _check_relay_live(harness, scenario, violations, details)
    finally:
        harness.close()
    # -- leak invariant (after teardown, with a settle grace) --
    fd_after = _fd_count()
    threads_after = threading.active_count()
    deadline = time.monotonic() + 5.0
    while ((fd_after > fd_before or threads_after > threads_before)
           and time.monotonic() < deadline):
        time.sleep(0.1)
        gc.collect()
        fd_after = _fd_count()
        threads_after = threading.active_count()
    if scenario.check_no_leaks:
        if fd_after > fd_before:
            violations.append(f"leak: {fd_after - fd_before} fds did "
                              f"not return to baseline")
        if threads_after > threads_before:
            violations.append(
                f"leak: {threads_after - threads_before} threads did "
                f"not return to baseline")
    # -- convergence invariant --
    fault_end = max(harness.fault_ticks) if harness.fault_ticks \
        else None
    converged_at: Optional[int] = None
    scan_from = fault_end + 1 if fault_end is not None else 0
    for t in range(scan_from, len(harness.eq_ticks)):
        if all(harness.eq_ticks[t:]):
            converged_at = t
            break
    ticks_to_converge = (converged_at - fault_end
                         if converged_at is not None
                         and fault_end is not None else None)
    if scenario.check_converge:
        if converged_at is None:
            violations.append(
                "converge: SUT never re-matched the flat reference "
                f"after the last fault (tick {fault_end})")
        elif (ticks_to_converge is not None
              and ticks_to_converge > scenario.converge_within):
            violations.append(
                f"converge: took {ticks_to_converge} ticks, budget "
                f"{scenario.converge_within}")
    if scenario.check_isolation:
        _check_isolation(harness, scenario, violations, details)
    if scenario.check_replay:
        _check_replay(scenario, harness.trace_dir, violations, details)
    if scenario.subscribers:
        healthy_stalled = [s for s in harness.subs
                           if s.stalled and s.stall_after_bytes
                           is not None]
        if healthy_stalled:
            violations.append(f"subscribers: {len(healthy_stalled)} "
                              f"still wedged at scenario end")
    report = ChaosReport(
        scenario=scenario.name, ok=not violations,
        violations=violations, ticks=scenario.ticks,
        fault_end_tick=fault_end, converged_at=converged_at,
        ticks_to_converge=ticks_to_converge,
        restarts_total=harness.restarts_total(),
        fd_delta=fd_after - fd_before,
        thread_delta=threads_after - threads_before,
        trace_dir=harness.trace_dir, details=details)
    with open(os.path.join(out_dir, "report.json"), "w") as f:
        json.dump(report.to_json(), f, indent=2, sort_keys=True)
    return report
