"""Process-per-shard supervision for the hierarchical fleet plane.

The port's copy of ``tpumon/supervisor.py``, imports renamed.  In-process
shards (:class:`~tpumon_torch.fleetshard.ShardedFleet`) share one GIL, so
the parallel form is one OS process per shard.  :class:`ShardSupervisor`
spawns each :class:`~tpumon_torch.fleetshard.FleetShard` as a CHILD
PROCESS (``python -m tpumon_torch.cli.fleet --shard-serve-unix``, the same
entry an operator would run), health-watches it, restarts it under a
budget, and re-admits it to the top-level
:class:`~tpumon_torch.fleetpoll.FleetPoller` — while the surviving shards
keep serving throughout (graceful degradation, never a full-fleet stall).

**Health watch** rides the existing agent-compatible surface, no new
protocol: the supervisor thread sends one ``hello`` per child a pass
(:func:`hello_probe`), and the shard's hello reply carries its own tick
health (``ticks_total`` advancing + ``fresh``, the serve-side twin of the
``tpumon_fleet_shard_up``/``last_tick_fresh`` staleness gauges).  A child
is judged unhealthy when its process exits, its hello stops answering, or
its tick counter stops advancing (the wedged-poller case — the serve
thread still answers hello while the poller thread is stuck, which is
exactly why the counter, not the connection, is the signal).

**Restart policy**: jittered exponential backoff between respawns (a
fleet-wide crash must not re-spawn every shard in synchronized storms —
same rationale, same jitter shape as the poller's reconnect backoff),
under a COUNTED restart budget: more than ``restart_budget`` restarts
inside ``budget_window_s`` parks the shard (circuit breaker).  A parked
shard is never restarted in a hot loop — it is surfaced as
``tpumon_fleet_shard_parked 1`` / ``up 0`` in the merged self-metrics and
its hosts render DOWN, until an operator calls
:meth:`ShardSupervisor.unpark` (or restarts the supervisor).

**Re-admission is free** by construction: the child rebinds the same
unix socket path, and the top-level poller's reconnect already resets the
delta tables on both sides, so the first post-restart sweep is a full
keyframe.  The supervisor only clears the top poller's earned backoff for
that endpoint (:meth:`~tpumon_torch.fleetpoll.FleetPoller.reset_backoff`,
drained on the poll thread) so re-admission happens on the next tick
instead of waiting out the dead predecessor's penalty.

Threading: the health watch runs on ONE supervisor thread; :meth:`poll`
runs on the caller's tick thread (single-owner, like every poller here);
:meth:`shard_stats` may be called from a metrics thread.  Shared child
state is guarded by ``ShardSupervisor._lock``; all child-process and
socket IO happens OUTSIDE it.
"""

from __future__ import annotations

import json
import os
import random
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from . import log
from .backends.agent import _parse_address
from .fleetpoll import (FleetPoller, HostSample,
                        create_fleet_poller)
from .fleetshard import (SHARD_FIELDS, ShardAggregateView,
                         partition_targets, shard_metric_lines)

#: child states (the ``state`` key of :meth:`ShardSupervisor.shard_stats`)
RUNNING = "running"
BACKOFF = "backoff"
PARKED = "parked"


def _poll_rc(proc: "subprocess.Popen[bytes]") -> Optional[int]:
    """``Popen.poll`` through an annotated seam so the conservative
    call graph types the receiver as external instead of
    fallback-edging the call into every repo ``.poll()``."""

    return proc.poll()


def _popen_wait(proc: "subprocess.Popen[bytes]",
                timeout_s: float) -> None:
    """``Popen.wait`` through the same annotated seam (repo classes
    define ``.wait()`` too); raises ``TimeoutExpired`` like the
    original."""

    proc.wait(timeout=timeout_s)


def hello_probe(address: str, timeout_s: float,
                client: str = "tpumon-supervisor"
                ) -> Optional[Dict[str, Any]]:
    """One agent-protocol ``hello`` over a throwaway blocking socket:
    the supervisor's liveness probe.  Deliberately NOT an
    :class:`~tpumon_torch.backends.agent.AgentBackend` — the probe needs no
    negotiation, no delta state, and no shared-class coupling between
    the supervisor thread and the sweep planes; a dead endpoint costs
    one bounded connect attempt.  Returns the hello reply dict, or
    ``None`` on any transport/protocol failure."""

    kind, target = _parse_address(address)
    try:
        s = socket.socket(
            socket.AF_UNIX if kind == "unix" else socket.AF_INET,
            socket.SOCK_STREAM)
    except OSError:
        return None
    try:
        s.settimeout(timeout_s)
        s.connect(target)
        s.sendall(json.dumps(
            {"op": "hello", "client": client, "version": "0.1.0"},
            separators=(",", ":")).encode("utf-8") + b"\n")
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = s.recv(65536)
            if not chunk:
                return None
            buf += chunk
            if len(buf) > (1 << 20):
                return None  # not a hello reply; do not buffer forever
        resp = json.loads(buf)
    except (OSError, ValueError):
        return None
    finally:
        try:
            s.close()
        except OSError:
            pass
    if isinstance(resp, dict) and resp.get("ok"):
        return resp
    return None


class ShardChild:
    """One supervised shard: its spec (id, host subset, socket path,
    spawn argv) plus the live process/health state the supervisor
    thread maintains.  All mutable fields are guarded by the owning
    supervisor's ``_lock`` except the process handle itself (the
    supervisor thread is its only writer after construction)."""

    def __init__(self, shard_id: int, targets: Sequence[str],
                 sock_path: str, targets_file: str,
                 log_path: str) -> None:
        self.shard_id = int(shard_id)
        self.targets = list(targets)
        self.sock_path = sock_path
        self.address = f"unix:{sock_path}"
        self.targets_file = targets_file
        self.log_path = log_path
        # process state (supervisor thread writes)
        self.proc: Optional["subprocess.Popen[bytes]"] = None
        self.state = BACKOFF          # nothing spawned yet
        self.parked = False
        self.last_error = ""
        # restart accounting (the circuit breaker's evidence)
        self.restarts_total = 0
        self.restart_times: List[float] = []   # monotonic, windowed
        self.backoff_s = 0.0
        self.backoff_until = 0.0
        # health-watch state
        self.spawned_mono = 0.0
        self.last_progress_mono = 0.0
        self.last_ticks_total = -1
        self.hello_ok = False
        self.fresh = True
        self.last_stats: Dict[str, Any] = {}


class ShardSupervisor:
    """Spawn, health-watch, restart and re-admit ``shards`` fleet-shard
    child processes; consume them through one top-level
    :class:`~tpumon_torch.fleetpoll.FleetPoller` exactly like
    :class:`~tpumon_torch.fleetshard.ShardedFleet` consumes its threads.
    :meth:`poll` is drop-in for ``FleetPoller.poll`` — per-host samples
    in the original target order.
    """

    def __init__(self, targets: Sequence[str],
                 field_ids: Sequence[int],
                 shards: int = 4,
                 *,
                 delay_s: float = 1.0,
                 timeout_s: float = 3.0,
                 run_dir: Optional[str] = None,
                 backoff_base_s: float = 0.5,
                 backoff_max_s: float = 30.0,
                 restart_budget: int = 5,
                 budget_window_s: float = 60.0,
                 health_interval_s: float = 0.5,
                 stale_after_s: float = 10.0,
                 spawn_grace_s: float = 15.0,
                 backoff_jitter: Optional[Callable[[], float]] = None,
                 spawn_fn: Optional[Callable[["ShardChild"],
                                             "subprocess.Popen[bytes]"]]
                 = None,
                 blackbox_dir: Optional[str] = None,
                 blackbox_max_bytes: Optional[int] = None,
                 top_blackbox_dir: Optional[str] = None,
                 top_stream_hub: Optional[Any] = None,
                 poller_backoff_base_s: Optional[float] = None,
                 poller_backoff_max_s: Optional[float] = None) -> None:
        """``delay_s`` is the CHILDREN's tick cadence (they self-pace;
        serving is pull-based so the supervisor's own :meth:`poll`
        cadence is independent).  ``spawn_fn`` replaces the default
        ``python -m tpumon_torch.cli.fleet --shard-serve-unix`` spawn (tests script child
        behavior with it); ``backoff_jitter`` is the multiplier source
        for restart backoff, defaulting to ``uniform(0.5, 1.0)`` like
        the poller's reconnect jitter."""

        self.targets = list(targets)
        self._fields = [int(f) for f in field_ids]
        self._delay_s = float(delay_s)
        self._timeout_s = float(timeout_s)
        self._backoff_base_s = float(backoff_base_s)
        self._backoff_max_s = float(backoff_max_s)
        self._restart_budget = int(restart_budget)
        self._budget_window_s = float(budget_window_s)
        self._health_interval_s = float(health_interval_s)
        self._stale_after_s = float(stale_after_s)
        self._spawn_grace_s = float(spawn_grace_s)
        self._backoff_jitter = backoff_jitter or (
            lambda: random.uniform(0.5, 1.0))
        self._spawn_fn = spawn_fn or (
            lambda c: _spawn_shard_child(c, self._spawn_argv(c)))
        self._blackbox_dir = blackbox_dir
        self._blackbox_max_bytes = blackbox_max_bytes
        #: reconnect-backoff overrides plumbed BOTH ways: to the
        #: top-level poller and to every child's own poller (so
        #: recovery follows the caller's cadence, not the default
        #: dial-retry's)
        self._poller_backoff_base_s = poller_backoff_base_s
        self._poller_backoff_max_s = poller_backoff_max_s
        self._own_run_dir = run_dir is None
        self.run_dir = run_dir or tempfile.mkdtemp(
            prefix="tpumon-supervise-")
        #: guards child health/restart state (supervisor thread writes;
        #: poll/metrics threads read) and the re-admission queue
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: addresses whose top-poller backoff should be cleared (filled
        #: by the supervisor thread on respawn, drained by poll())
        self._readmit: List[str] = []
        #: CPU the health watch itself has burned (supervisor-thread
        #: time.thread_time deltas) — the "<1% of tick CPU"
        #: steady-overhead bar reads this
        self.health_cpu_s_total = 0.0
        self.health_passes_total = 0
        self.children: List[ShardChild] = []
        partition = partition_targets(self.targets, shards)
        # passive setup first, OS resources last (partial-init
        # discipline): the run-dir files and child specs
        try:
            os.makedirs(self.run_dir, exist_ok=True)
            for i, idxs in enumerate(partition):
                tf = os.path.join(self.run_dir, f"shard-{i}.targets")
                with open(tf, "w") as f:
                    f.write("".join(self.targets[j] + "\n"
                                    for j in idxs))
                self.children.append(ShardChild(
                    i, [self.targets[j] for j in idxs],
                    os.path.join(self.run_dir, f"shard-{i}.sock"), tf,
                    os.path.join(self.run_dir, f"shard-{i}.log")))
            self._view = ShardAggregateView(self.targets, partition)
            top_kwargs: Dict[str, Any] = {}
            if poller_backoff_base_s is not None:
                top_kwargs["backoff_base_s"] = poller_backoff_base_s
            if poller_backoff_max_s is not None:
                top_kwargs["backoff_max_s"] = poller_backoff_max_s
            self._top = create_fleet_poller(
                [c.address for c in self.children], SHARD_FIELDS,
                timeout_s=timeout_s, client_name="tpumon-fleet-super",
                blackbox_dir=top_blackbox_dir,
                stream_hub=top_stream_hub, **top_kwargs)
        except BaseException:
            if self._own_run_dir:
                shutil.rmtree(self.run_dir, ignore_errors=True)
            raise
        try:
            now = time.monotonic()
            for c in self.children:
                self._respawn(c, now, first=True)
        except BaseException:
            self.close()
            raise
        self.last_top_tick_s = 0.0

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> None:
        """Start the health-watch thread (spawning already happened in
        the constructor — a supervisor that is never started still
        serves whatever its children produce, it just never restarts
        one)."""

        self._thread = threading.Thread(
            target=self._run, daemon=True, name="tpumon-supervisor")
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            try:
                t.join(timeout=10.0)
            except RuntimeError:
                # join-before-start is impossible here, but a raising
                # join must not skip the child teardown below
                pass
        # children die with the supervisor: TERM, bounded wait, KILL —
        # each step best-effort per child so one zombie cannot leak
        # its siblings
        for c in self.children:
            self._signal_child(c, signal.SIGTERM)
        deadline = time.monotonic() + 5.0
        for c in self.children:
            p = c.proc
            if p is None:
                continue
            try:
                _popen_wait(p, max(0.0, deadline - time.monotonic()))
            except (subprocess.TimeoutExpired, OSError):
                self._signal_child(c, signal.SIGKILL)
                try:
                    _popen_wait(p, 5.0)
                except (subprocess.TimeoutExpired, OSError) as e:
                    log.warn_every("supervisor.close", 30.0,
                                   "shard %d child would not die: %r",
                                   c.shard_id, e)
            c.proc = None
        try:
            self._top.close()
        finally:
            if self._own_run_dir:
                shutil.rmtree(self.run_dir, ignore_errors=True)

    # -- consume (caller's tick thread) ----------------------------------------

    def poll(self) -> List[HostSample]:
        """One top-level tick over the shard endpoints, rebuilt to
        per-host rows.  Children self-pace their downstream sweeps, so
        this never blocks on a shard's tick — a dead or parked shard
        costs its rows DOWN, nothing else."""

        with self._lock:
            pending, self._readmit = self._readmit, []
        for address in pending:
            # the replacement child is known-fresh: do not make it
            # wait out its dead predecessor's reconnect backoff
            self._top.reset_backoff(address)
        t0 = time.monotonic()
        top_samples = self._top.poll()
        self.last_top_tick_s = time.monotonic() - t0
        return self._view.rebuild(
            [c.address for c in self.children], top_samples,
            self._top.raw_snapshots())

    def last_changed_flags(self) -> List[bool]:
        return self._view.changed_flags(
            [c.address for c in self.children],
            self._top.raw_snapshots(),
            self._top.last_changed_flags())

    @property
    def top(self) -> FleetPoller:
        return self._top

    # -- operator surface ------------------------------------------------------

    def unpark(self, shard_id: int) -> None:
        """Clear a parked shard's circuit breaker and schedule an
        immediate respawn attempt (the operator's reset, after fixing
        whatever made it flap)."""

        with self._lock:
            for c in self.children:
                if c.shard_id == shard_id and c.parked:
                    c.parked = False
                    c.state = BACKOFF
                    c.restart_times.clear()
                    c.backoff_s = 0.0
                    c.backoff_until = 0.0

    def shard_stats(self) -> List[Dict[str, Any]]:
        """Merged per-shard gauges: the child's own tick stats (from
        its hello) plus the supervision state — the
        ``tpumon_fleet_shard_*`` families with ``restarts_total`` /
        ``parked`` on top."""

        out: List[Dict[str, Any]] = []

        # the waitpid probe happens OUTSIDE the lock (it is a syscall;
        # the supervisor thread takes this lock on its health path) —
        # and reads c.proc ONCE: the supervisor thread nulls it on
        # failure, and a scrape racing that must not re-read between
        # the None check and the poll
        def proc_alive(c: ShardChild) -> bool:
            p = c.proc
            return p is not None and _poll_rc(p) is None

        alive = [proc_alive(c) for c in self.children]
        with self._lock:
            for c, proc_alive in zip(self.children, alive):
                up = (proc_alive
                      and c.hello_ok and c.fresh and not c.parked)
                out.append({
                    "shard": c.shard_id,
                    "hosts": len(c.targets),
                    "up": 1 if up else 0,
                    "ticks_total": max(0, c.last_ticks_total),
                    "tick_seconds": float(
                        c.last_stats.get("tick_seconds", 0.0)),
                    "hosts_down": int(
                        c.last_stats.get("hosts_down", 0)),
                    "restarts_total": c.restarts_total,
                    "parked": 1 if c.parked else 0,
                    "state": PARKED if c.parked else c.state,
                    "last_error": c.last_error,
                })
        return out

    def self_metric_lines(self) -> List[str]:
        return supervisor_metric_lines(self.shard_stats())

    # -- health watch (supervisor thread) --------------------------------------

    def _run(self) -> None:
        while not self._stop.wait(self._health_interval_s):
            try:
                cpu0 = time.thread_time()
                self._health_pass(time.monotonic())
                self.health_cpu_s_total += time.thread_time() - cpu0
                self.health_passes_total += 1
            except Exception as e:  # noqa: BLE001 — the watch must
                # outlive any single surprise (a dying child can race
                # every call here); one bad pass skips, never kills
                # the supervision loop
                log.warn_every("supervisor.health", 30.0,
                               "health pass failed: %r", e)

    def _health_pass(self, now: float) -> None:
        for c in self.children:
            if c.parked:
                continue
            proc = c.proc
            if proc is None:
                # in backoff: respawn when due
                if now >= c.backoff_until:
                    self._respawn(c, now)
                continue
            rc = _poll_rc(proc)
            if rc is not None:
                self._child_failed(c, f"exited rc={rc}", now)
                continue
            stats = self._hello_check(c)
            in_grace = now - c.spawned_mono < self._spawn_grace_s
            if stats is None:
                with self._lock:
                    c.hello_ok = False
                if (not in_grace and now - c.last_progress_mono
                        > self._stale_after_s):
                    self._kill_child(c)
                    self._child_failed(
                        c, f"hello unreachable for "
                           f"{self._stale_after_s:.0f}s: "
                           f"{c.last_error}", now)
                continue
            ticks = int(stats.get("ticks_total", 0))
            with self._lock:
                c.hello_ok = True
                c.fresh = bool(stats.get("fresh", True))
                c.last_stats = stats
                if ticks != c.last_ticks_total:
                    c.last_ticks_total = ticks
                    c.last_progress_mono = now
                    # a progressing child has RECOVERED: forget its
                    # earned backoff (same reset-on-success the
                    # poller's reconnect backoff has) — an isolated
                    # crash per hour must not ratchet every future
                    # recovery to the 30 s ceiling.  Flapping is the
                    # restart BUDGET's job, not the backoff's.
                    c.backoff_s = 0.0
                    stale = False
                else:
                    stale = (not in_grace
                             and now - c.last_progress_mono
                             > self._stale_after_s)
            if stale:
                # the wedged-poller case: hello answers (serve thread
                # alive) but the tick counter is frozen — kill and
                # restart, counted like any other failure
                self._kill_child(c)
                self._child_failed(
                    c, f"tick counter stuck at {ticks} for "
                       f"{self._stale_after_s:.0f}s", now)

    def _hello_check(self, c: ShardChild) -> Optional[Dict[str, Any]]:
        """One :func:`hello_probe` against the child's endpoint,
        narrowed to the shard-health block; ``None`` on any failure.
        Supervisor thread only."""

        hello = hello_probe(c.address, min(self._timeout_s, 2.0))
        if hello is None:
            with self._lock:
                c.last_error = "hello probe failed"
            return None
        shard = hello.get("shard")
        return dict(shard) if isinstance(shard, dict) else {}

    def _signal_child(self, c: ShardChild, sig: int) -> None:
        p = c.proc
        if p is None or _poll_rc(p) is not None:
            return
        try:
            p.send_signal(sig)
        except OSError:
            pass

    def _kill_child(self, c: ShardChild) -> None:
        """SIGKILL, not SIGTERM: a wedged child already proved it does
        not respond; reap it so the respawn can rebind the socket."""

        p = c.proc
        if p is None:
            return
        try:
            p.kill()
        except OSError:
            pass
        try:
            _popen_wait(p, 5.0)
        except (subprocess.TimeoutExpired, OSError) as e:
            log.warn_every("supervisor.kill", 30.0,
                           "shard %d did not reap after SIGKILL: %r",
                           c.shard_id, e)

    def _child_failed(self, c: ShardChild, why: str,
                      now: float) -> None:
        c.proc = None
        window_start = now - self._budget_window_s
        with self._lock:
            c.last_error = why
            c.hello_ok = False
            c.restart_times = [t for t in c.restart_times
                               if t >= window_start]
            if len(c.restart_times) >= self._restart_budget:
                # circuit breaker: flapping — park, surface, stop
                # burning restarts (and stop thrashing the fleet with
                # keyframe resyncs every backoff interval)
                c.parked = True
                c.state = PARKED
                log.warning(
                    "shard %d parked after %d restarts in %.0fs "
                    "(last: %s) — hosts render DOWN until unpark",
                    c.shard_id, len(c.restart_times),
                    self._budget_window_s, why)
                return
            c.backoff_s = min(
                max(self._backoff_base_s, c.backoff_s * 2.0),
                self._backoff_max_s)
            c.backoff_until = now + c.backoff_s * self._backoff_jitter()
            c.state = BACKOFF
            log.warning("shard %d down (%s); respawn in <=%.1fs "
                        "(restart %d)", c.shard_id, why, c.backoff_s,
                        c.restarts_total + 1)

    def _respawn(self, c: ShardChild, now: float,
                 first: bool = False) -> None:
        """Spawn (or respawn) one child.  Supervisor thread (or the
        constructor, before the thread exists)."""

        # a SIGKILLed child leaves its socket file behind; the
        # replacement must bind the SAME path (that is what makes
        # re-admission free — the top poller just reconnects)
        try:
            os.unlink(c.sock_path)
        except OSError:
            pass
        try:
            proc = self._spawn_fn(c)
        except OSError as e:
            with self._lock:
                c.last_error = f"spawn: {e}"
                c.backoff_s = min(
                    max(self._backoff_base_s, c.backoff_s * 2.0),
                    self._backoff_max_s)
                c.backoff_until = (now + c.backoff_s
                                   * self._backoff_jitter())
            log.warn_every("supervisor.spawn", 30.0,
                           "shard %d spawn failed: %r", c.shard_id, e)
            return
        c.proc = proc
        with self._lock:
            c.state = RUNNING
            c.spawned_mono = now
            c.last_progress_mono = now
            c.last_ticks_total = -1
            c.hello_ok = False
            c.fresh = True
            if not first:
                c.restarts_total += 1
                c.restart_times.append(now)
                self._readmit.append(c.address)

    def _spawn_argv(self, c: ShardChild) -> List[str]:
        """The child's command line — exactly the manual form an
        operator would run, which is the point: supervised and manual
        shards are the same program."""

        argv = [sys.executable, "-m", "tpumon_torch.cli.fleet",
                "--targets-file", c.targets_file,
                "--shard-serve-unix", c.sock_path,
                "--shard-id", str(c.shard_id),
                "-d", str(self._delay_s),
                "--timeout", str(self._timeout_s)]
        if self._blackbox_dir is not None:
            argv += ["--blackbox-dir", self._blackbox_dir]
        if self._blackbox_max_bytes is not None:
            argv += ["--blackbox-max-bytes",
                     str(self._blackbox_max_bytes)]
        if self._poller_backoff_base_s is not None:
            argv += ["--backoff-base", str(self._poller_backoff_base_s)]
        if self._poller_backoff_max_s is not None:
            argv += ["--backoff-max", str(self._poller_backoff_max_s)]
        return argv


def spawn_logged_child(argv: Sequence[str], log_path: str
                       ) -> "subprocess.Popen[bytes]":
    """Spawn a child process with the ``tpumon_torch`` package
    importable and its output teed to ``log_path`` — the ONE spawn shape
    every supervised child uses: own session (a signal aimed at the
    child must never hit the parent's group), ``stdin=DEVNULL``,
    append-mode log."""

    env = dict(os.environ)
    repo_root = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get(
        "PYTHONPATH", "")
    with open(log_path, "ab") as logf:
        return subprocess.Popen(argv, stdin=subprocess.DEVNULL,
                                stdout=logf, stderr=logf, env=env,
                                start_new_session=True)


def _spawn_shard_child(c: ShardChild, argv: Sequence[str]
                       ) -> "subprocess.Popen[bytes]":
    """Default spawn for one shard child: fresh log file per spawn —
    the previous incarnation's tail is the crash evidence, kept as
    ``.log.1``."""

    try:
        os.replace(c.log_path, c.log_path + ".1")
    except OSError:
        pass
    return spawn_logged_child(argv, c.log_path)


def supervisor_metric_lines(stats: Sequence[Dict[str, Any]]
                            ) -> List[str]:
    """The merged self-metric surface: the ``tpumon_fleet_shard_*``
    families every shard mode serves, plus the supervision families —
    a parked shard is ``up 0, parked 1``; a restarting one is ``up 0,
    parked 0`` with its counter climbing."""

    from .exporter.promtext import render_family_samples

    lines = shard_metric_lines(stats)
    for fam, ptype, help_txt, key, fmt in (
            ("tpumon_fleet_shard_restarts_total", "counter",
             "Times the supervisor respawned the shard child.",
             "restarts_total", "d"),
            ("tpumon_fleet_shard_parked", "gauge",
             "1 when the shard hit its restart budget and is parked "
             "(circuit breaker; unpark to clear).", "parked", "d")):
        lines += render_family_samples(
            fam, ptype, help_txt,
            [(f'shard="{st["shard"]}"', st.get(key, 0))
             for st in stats], fmt)
    return lines
