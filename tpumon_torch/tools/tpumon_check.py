#!/usr/bin/env python3
"""tpumon-check — whole-program static analysis for the tpumon hot paths.

The port's copy of the JAX package's whole-program check, passes 1-7,
with the reference's rule names, pragma syntax and CLI, pointed at
``tpumon_torch/`` and ``tpumon_torch/native/`` and with manifests
written for the port's own threads and hot roots.

``tpumon_torch/tools/tpumon_lint.py`` guards the hot-path invariants with
*filename-scoped* rules: ``blocking-socket`` only looks at
``fleetpoll.py``, ``json-in-sweep-path`` at a hand-listed file set, and
so on.  One helper extracted into a new module silently escapes every
rule.  This tool closes that hole with a repo-wide **call graph** over
``tpumon_torch/`` and the analysis passes on top of it — same
zero-dependency discipline (stdlib ``ast`` + regex only):

**1. Hot-path reachability** (``hot-*`` rules).  A declarative manifest
of hot roots (``HOT_ROOTS``: the fleet multiplexer tick, the exporter
sweep, the incremental renderer, the frame codec, the flight-recorder
append path) from which "hotness" propagates through resolved calls.
The lint rules' property checks are re-applied to every function
*reachable* from the relevant roots, whatever file it lives in.  The
old filename scoping is kept as an additional scope (a cross-check
until parity is shown — ``tests/test_torch_check.py`` proves every site the
legacy scopes cover is covered here too), so this pass strictly
supersedes the per-file rules.

**2. Lock analysis** (``lock-order-cycle``, ``blocking-while-locked``).
Lock acquisition sites (``with <lock>:``) are collected per function,
held-lock sets are propagated through the call graph to a fixpoint, and
the pass flags (a) acquisition-order cycles between named locks and
(b) blocking calls (socket ops, ``sleep``, ``fsync``, subprocess,
buffered flush) made while any lock is held.  This is the static
complement of the concurrency tests and the TSan runs
(``tests/test_torch_sanitizers.py``).

**3. Thread provenance + guarded-by** (``thread-*`` rules).  A
declarative ``THREAD_ROOTS`` manifest (plus an automatic harvest of
``threading.Thread(target=...)`` spawns and module-level ``main``
functions) names every thread the process runs; roles propagate
through the call graph so each function knows the set of threads that
may execute it.  Every ``self.attr`` read/write site is then joined
with a MUST-hold lock fixpoint to infer, per (class, attribute), the
locks consistently held at mutation — and to flag attributes written
from two roles with no common lock (``thread-unguarded-write``),
in-place container mutations read off-role
(``thread-torn-read``), and thread-affine objects (selectors,
sockets, frame-codec tables) touched from two roles
(``thread-affinity``).  Accepted races carry a mandatory-reason
``# tpumon: thread-ok(reason)`` pragma, inventoried in the ``--json``
artifact and diffed against ``tpumon_torch/tools/check_baseline.json``.

**4. Wire-protocol constant sync** (``wire-constant-sync``).  The
catalog-native-sync idea extended to the wire: frame magics, record
tags, op names, value-entry/event field numbers and the integral-dump
limit are extracted from ``tpumon_torch/sweepframe.py`` /
``tpumon_torch/wire.py`` / ``tpumon_torch/blackbox.py``, from
``tpumon_torch/native/agent/main.cc`` / ``wire.hpp``, from the specs
(``tpumon_torch/native/agent/protocol.md``,
``tpumon_torch/docs/blackbox.md``), the varint cap of the two protobuf
walkers (``tpumon_torch/wire.py`` against ``agent/wire.hpp``) and, when
it is built, from the ``_tpumon_torch_codec`` extension's exported
constants, then cross-checked — the Python twin, the C++ agent and
the docs can never drift apart silently.

**5. Exception flow + resource lifetime** (``swallowed-exception``,
``leak-on-exceptional-path``, ``close-not-aggregating``,
``partial-init-leak``).  An interprocedural raise-set fixpoint (what
each function can raise, filtered through the ``except`` clauses its
callers wrap around the call site) plus a must-close lifetime scan
for registry-identified resources — sockets, selectors, files, thread
handles, and every repo class with a ``close()``/``stop()``: a
resource acquired in a function must reach ``close()``/``with``-exit
or be handed off on *every* path including exceptional ones,
``close()``-shaped teardown methods must be exception-aggregating (a
raising member close may not skip the remaining members), partial
constructor failure must release already-acquired members, and broad
``except`` clauses on a hot or teardown path may not swallow
silently.  Accepted exceptions carry a mandatory-reason
``# tpumon: close-ok(reason)`` pragma, inventoried in the baseline.

**6. Effect-budget inference** (``effect-budget``).  Per-function
effect signatures (allocates, lock acquire, blocking call, syscall,
raises) are joined with a declarative ``EFFECT_BUDGETS`` manifest
over the ``HOT_ROOTS`` roots: the burst inner fold and the codec
steady paths *declare* which effects they may never reach, turning
the filename-scoped ``mutex-in-burst-loop`` / hot-path lint rules
into whole-program reachability properties that guard the
steady-state ~zero-cost claims the benches pin dynamically.
Accepted effects carry ``# tpumon: effect-ok(reason)``.

**7. The native analysis plane** (``gil-discipline``,
``gil-region-unbalanced``, ``seqlock-discipline``,
``native-effect-budget``, ``raii-lifetime``).  The perf-critical
surface lives in ``tpumon_torch/native/`` (the codec core, the poll
engine, the ``gpu-hostengine`` agent over NVML, the seqlock burst
sampler), so the same whole-program discipline is
applied there: a dependency-free C++ lexer (comments, strings, raw
strings, preprocessor lines) feeds a declaration index over
``tpumon_torch/native/`` with a name-resolved call graph, and four rule families
run on top — no CPython API reachable inside a
``Py_BEGIN/END_ALLOW_THREADS`` region (and every BEGIN must pair
structurally with an END), the seqlock cells must keep their atomics
and orderings, a
``NATIVE_EFFECT_BUDGETS`` manifest mirrors pass 6 over native hot
roots (the burst fold, the SweepDelta encode, the sweep serve path
through ``nvml_source.hpp``, the codec fold and encode, the poll
engine's dispatch), and fds/sockets/``new`` in the agent must reach
close/delete/handoff on every return path.  The same pragmas work
behind ``//``: accepted effects carry ``// tpumon: effect-ok(reason)``
(or ``close-ok`` for lifetimes), counted in the baseline like every
other kind.  The pass also extracts the daemon's op dispatch as an op
-> handler table from the call graph (replacing the regex literal
scan pass 4 started with).

Call-graph resolution (deliberately conservative):

* ``self.method()`` resolves through the class and its repo-internal
  bases, **plus every subclass override** (virtual dispatch).
* ``module.func()`` / imported names resolve through each module's
  import table (relative imports included).
* ``obj.method()`` resolves when ``obj``'s type is inferable from
  parameter/attribute annotations or ``x = ClassName(...)``
  assignments; an annotation naming an external type (``socket.socket``)
  proves the call leaves the repo.
* Anything else falls back to *every* repo method of that name
  (conservative dynamic dispatch), except a curated list of builtin
  container/IO method names that would connect the graph to noise.
* Defining a nested function or lambda counts as potentially calling it.

Suppression: ``# tpumon-check: disable=rule`` on the offending line or
the enclosing ``def``'s signature — and for the ``hot-*`` twins of the
legacy lint rules the corresponding ``# tpumon-lint: disable=...``
pragma is honored too, so a site suppressed for the old rule needs no
second pragma.  Run as ``python -m tpumon_torch.tools.tpumon_check
--baseline tpumon_torch/tools/check_baseline.json``; exits non-zero
when findings remain or the baseline drifts; ``--json PATH``
additionally writes machine-readable findings.  See
``tpumon_torch/docs/static_analysis.md``.
"""

from __future__ import annotations

import argparse
import ast
import json as _json
import os
import re
import sys
import time as _time
from collections import Counter
from dataclasses import dataclass, field as dc_field
from typing import (Dict, FrozenSet, Iterator, List, Optional, Sequence,
                    Set, Tuple)

# -- rule registry -------------------------------------------------------------

RULES: Dict[str, str] = {
    "hot-blocking-socket": (
        "blocking socket primitive in a function reachable from the "
        "single-threaded fleet multiplexer tick"),
    "hot-wallclock": (
        "time.time() in a function reachable from a hot sweep root "
        "(deadlines/intervals must use time.monotonic())"),
    "hot-json": (
        "json.loads()/json.dumps() in a function reachable from a hot "
        "sweep root: the sweep path is binary delta frames"),
    "hot-encode": (
        "str.encode()/str.splitlines() in a function reachable from "
        "the exporter sweep/render roots: the pipeline is "
        "bytes-oriented and incremental"),
    "hot-fsync": (
        "fsync/fdatasync/flush in a function reachable from the "
        "flight-recorder append roots: flushing is time-based, never "
        "per sweep"),
    "hot-python-codec": (
        "a pure-Python codec implementation (PySweepFrameEncoder/"
        "PySweepFrameDecoder/PyBurstAccumulator hot loops) is "
        "reachable from a hot root — hot paths must dispatch through "
        "the facades so the native core serves when built"),
    "lock-order-cycle": (
        "two locks are acquired in opposite orders on some path "
        "through the call graph — a textbook ABBA deadlock"),
    "lock-self-recursion": (
        "a plain (non-reentrant) threading.Lock is re-acquired on a "
        "path where it is already held — a guaranteed self-deadlock"),
    "blocking-while-locked": (
        "a blocking call (socket op, sleep, fsync, subprocess, "
        "buffered flush) made while holding a lock"),
    "wire-constant-sync": (
        "protocol constants (magics, record tags, op names, field "
        "numbers) disagree between tpumon_torch/, its native agent and the "
        "specs"),
    "thread-unguarded-write": (
        "an attribute is written from two different thread roles with "
        "no common lock held at the write sites — concurrent writers "
        "can interleave and tear the state"),
    "thread-torn-read": (
        "an attribute mutated in place (dict/list/set update) on one "
        "thread role is read from another role with no common lock — "
        "the reader can observe a half-applied mutation"),
    "thread-affinity": (
        "a thread-affine object (selector, socket, frame codec table) "
        "is touched from two different thread roles — these objects "
        "have an owning thread, locks do not make them shareable"),
    "thread-root-undeclared": (
        "a threading.Thread(target=...) site spawns a repo function "
        "that is not declared in THREAD_ROOTS — the race pass does "
        "not know this thread exists"),
    "thread-root-missing": (
        "a THREAD_ROOTS manifest entry does not resolve to a function "
        "in the repo — the race pass is silently weaker"),
    "hot-root-missing": (
        "a HOT_ROOTS manifest entry does not resolve to a function in "
        "the repo — the reachability pass is silently weaker"),
    "swallowed-exception": (
        "a broad except clause on a hot or teardown path whose body "
        "neither logs, re-raises nor handles — the failure vanishes "
        "exactly where visibility matters most"),
    "leak-on-exceptional-path": (
        "a registry resource (socket, selector, file, thread handle, "
        "closeable repo object) is acquired but does not reach "
        "close()/with-exit or a handoff on every path — an exception "
        "between acquire and release leaks it"),
    "close-not-aggregating": (
        "a close()-shaped teardown method releases several members in "
        "sequence without per-member exception aggregation — one "
        "raising close skips every remaining member"),
    "partial-init-leak": (
        "__init__ acquires a resource member and later runs code that "
        "can raise with no handler releasing the already-acquired "
        "members — a failed constructor leaks them"),
    "effect-budget": (
        "a function reachable from a budgeted hot root performs an "
        "effect (alloc, lock, blocking, syscall, raise) the root's "
        "declared effect budget forbids"),
    "effect-root-missing": (
        "an EFFECT_BUDGETS manifest entry does not resolve to a "
        "function in the repo — the budget pass is silently weaker"),
    "gil-discipline": (
        "a CPython API call (Py* function or PyObject member access) "
        "is reachable — directly or through the native call graph — "
        "inside a Py_BEGIN/END_ALLOW_THREADS region, where the GIL is "
        "not held"),
    "gil-region-unbalanced": (
        "a Py_BEGIN_ALLOW_THREADS does not structurally pair with a "
        "Py_END_ALLOW_THREADS on every path — mismatched brace depth, "
        "a return/goto escaping the region, or a missing END"),
    "seqlock-discipline": (
        "a seqlock cell breaks the single-writer seqlock idiom: data "
        "words must be std::atomic, the writer must enter odd with an "
        "ordered RMW and publish even with release, and readers must "
        "acquire-load the sequence (fence before a relaxed recheck)"),
    "native-effect-budget": (
        "a native function reachable from a declared native hot root "
        "performs an effect (mutex acquisition, heap allocation, "
        "blocking call) the root's budget forbids"),
    "native-effect-root-missing": (
        "a NATIVE_EFFECT_BUDGETS manifest entry does not resolve to a "
        "function in the native index — the budget pass is silently "
        "weaker"),
    "raii-lifetime": (
        "an fd/socket/heap object acquired in a native function does "
        "not reach close/delete or a handoff on every return path — "
        "the C++ twin of leak-on-exceptional-path"),
    "parse-error": (
        "file does not parse — every graph-based rule is moot until "
        "it does"),
}

#: sentinel type for receivers proven to live outside the repo (an
#: annotation naming e.g. ``socket.socket``): no call edge, no fallback
EXTERNAL = "<external>"

#: hot-root manifest: group -> [\"rel/path.py::Qual.name\", ...].  Add a
#: root here when a new hot path of the port lands
#: (tpumon_torch/docs/static_analysis.md).
HOT_ROOTS: Dict[str, List[str]] = {
    # the fleet multiplexer: ONE thread sweeping every host — its whole
    # connection state machine hangs off poll()
    "fleet": ["tpumon_torch/fleetpoll.py::FleetPoller.poll"],
    # the poll engine's Python facade (``_tpumon_torch_poll``): record
    # replay, the steady-host shortcut and the per-tick engine calls —
    # everything Python still runs per tick when the C++ engine owns the
    # sockets, so a blocking call or a pure-Python codec hop here
    # multiplies by the fleet size exactly like the poll() it mirrors
    "poll": ["tpumon_torch/fleetpoll.py::NativeFleetPoller.poll"],
    # the exporter sweep (collect + record + render + publish): the
    # daemon's over NVML or an agent, and the self-monitor's over the
    # CUDA backend and its trace engine
    "exporter": ["tpumon_torch/exporter/exporter.py::TpuExporter"
                 ".sweep_bytes"],
    # the incremental renderer's delta path
    "render": ["tpumon_torch/exporter/promtext.py::SweepRenderer"
               ".render_parts"],
    # the codec facades: encoder (the executable spec of the agents'
    # sweep_frame, and the flight recorder's on-disk writer) + hot parse
    "codec": ["tpumon_torch/sweepframe.py::SweepFrameEncoder.encode_frame",
              "tpumon_torch/sweepframe.py::SweepFrameDecoder.apply"],
    # the flight-recorder append path (runs on the sweep thread)
    "blackbox": ["tpumon_torch/blackbox.py::BlackBoxWriter.record_sweep",
                 "tpumon_torch/blackbox.py::BlackBoxWriter.record_kmsg"],
    # the streaming tee: publish() runs on the sweep thread, the
    # fan-out + pump on the frame server's single loop thread — a
    # blocking send anywhere in this closure would stall every
    # subscriber (or the sweep itself)
    "stream": ["tpumon_torch/frameserver.py::StreamPublisher.publish",
               "tpumon_torch/frameserver.py::FrameServer._pump"],
    # the hierarchical shard: the agent-compatible serve surface (per
    # upstream tick on the frame server's loop thread) and the
    # row-table feed (per downstream tick on the shard thread)
    "shard": ["tpumon_torch/fleetshard.py::_ShardHandler.on_binary",
              "tpumon_torch/fleetshard.py::_ShardHandler.on_json",
              "tpumon_torch/fleetshard.py::FleetShard._feed"],
    # the burst engine: the 50-100 Hz inner fold (anything blocking,
    # allocating or encoding per sample multiplies by the inner rate)
    # and the 1 Hz harvest, which runs on the sweep thread
    "burst": ["tpumon_torch/burst.py::BurstAccumulator.fold",
              "tpumon_torch/burst.py::BurstAccumulator.fold_series",
              "tpumon_torch/burst.py::BurstSampler._run",
              "tpumon_torch/burst.py::BurstSampler.harvest_if_due"],
    # the supervisor's per-tick consume path: it runs on the caller's
    # tick cadence and must never block on a child's health (the
    # health watch has its own thread for exactly that)
    "supervisor": ["tpumon_torch/supervisor.py::ShardSupervisor.poll"],
    # the chaos harness's timeline driver: one reference sweep + one
    # SUT sweep + trace recording per scheduled tick
    "chaos": ["tpumon_torch/chaos.py::ChaosHarness.run_tick"],
    # the streaming detection plane: observe() rides the sweep/fleet
    # hot paths, observe_kmsg() the drained kernel-log evidence — an
    # index-only steady tick costs ~zero, so nothing in this closure
    # may block, lock or touch the clock (the engine takes `now`)
    "anomaly": ["tpumon_torch/anomaly.py::AnomalyEngine.observe",
                "tpumon_torch/anomaly.py::AnomalyEngine.observe_kmsg"],
    # the relay's per-record forward path: one parse + one mirror
    # apply + one verbatim fan-out per upstream tick
    "relay": ["tpumon_torch/relay.py::StreamRelay._handle_records"],
    # the port's Python agent (``python -m tpumon_torch.hostengine``):
    # the binary sweep_frame serve, on the frame server's loop thread
    # for every connected client — the Python twin of the native
    # agent's native-sweep-serve budget
    "agent": ["tpumon_torch/hostengine.py::AgentHandler.on_binary"],
}

_ALL_GROUPS = tuple(HOT_ROOTS)

#: effect-budget manifest: budget name -> roots + the effect kinds the
#: whole closure of those roots may never perform.  These are the
#: steady-state ~zero-cost claims the benches pin dynamically, here
#: made reachability properties: the burst inner fold is the hottest
#: loop in the repo (50-100x the sweep rate — one allocation or lock
#: per sample is the 100x-CPU regression), and the codec steady paths
#: run per sweep per connection where a lock, a syscall or a blocking
#: call would serialize every plane behind one subscriber.  Kinds:
#: ``alloc`` (container displays/comprehensions and allocating
#: builtins), ``lock`` (with-lock / .acquire()), ``blocking`` (socket
#: primitives, sleep, fsync, subprocess, buffered flush), ``syscall``
#: (open/os.*/socket constructors/subprocess/print), ``raise``
#: (an explicit raise statement not handled in-function).  Add a
#: budget when a new hot path lands (tpumon_torch/docs/static_analysis.md).
EFFECT_BUDGETS: Dict[str, Dict[str, Sequence[str]]] = {
    # the 50-100 Hz inner fold: a few local-variable ops per sample,
    # nothing else — the lock-free single-producer handoff contract
    "burst-fold": {
        "roots": ["tpumon_torch/burst.py::BurstAccumulator.fold",
                  "tpumon_torch/burst.py::BurstAccumulator.fold_series"],
        "forbid": ("alloc", "lock", "blocking", "syscall", "raise"),
    },
    # the frame codec steady paths: encode/apply run per sweep per
    # connection on the sweep/loop threads — allocation is bounded by
    # the reused scratch buffers, but a lock, a syscall or a blocking
    # call here stalls every plane that shares the codec
    "codec-steady": {
        "roots": ["tpumon_torch/sweepframe.py::SweepFrameEncoder.encode_frame",
                  "tpumon_torch/sweepframe.py::SweepFrameDecoder.apply"],
        "forbid": ("lock", "blocking", "syscall"),
    },
    # the incremental renderer's delta path: cache hits must stay
    # pure in-memory splicing
    "render-steady": {
        "roots": ["tpumon_torch/exporter/promtext.py::SweepRenderer.render_parts"],
        "forbid": ("lock", "blocking", "syscall"),
    },
    # the shard-tree rebuild (ShardedFleet and ShardSupervisor both
    # consume through it, once per top-level tick): pure in-memory row
    # reconstruction — a lock, a syscall or a blocking call here would
    # couple every host's freshness to one shard's misbehavior
    "supervisor-rebuild": {
        "roots": ["tpumon_torch/fleetshard.py::ShardAggregateView.rebuild",
                  "tpumon_torch/fleetshard.py::ShardAggregateView"
                  ".changed_flags"],
        "forbid": ("lock", "blocking", "syscall"),
    },
    # the anomaly score path: pure in-memory streaming math on the
    # sweep/fleet owner thread — a lock, a syscall or a blocking call
    # here would couple every monitored host's tick to the detector,
    # and the "steady tick costs ~zero" bench claim would be a lie
    "anomaly-score": {
        "roots": ["tpumon_torch/anomaly.py::AnomalyEngine.observe",
                  "tpumon_torch/anomaly.py::AnomalyEngine.observe_kmsg"],
        "forbid": ("lock", "blocking", "syscall"),
    },
}

#: effect kinds every budget may reference (manifest typos fail fast)
EFFECT_KINDS = ("alloc", "lock", "blocking", "syscall", "raise")

#: the pass-5 rules the ``close-ok`` pragma suppresses
_CLOSE_OK_RULES = frozenset({
    "swallowed-exception", "leak-on-exceptional-path",
    "close-not-aggregating", "partial-init-leak",
})

#: thread-role manifest: role -> [entry functions that run ON that
#: thread].  Every ``threading.Thread(target=...)`` spawn of a repo
#: function must name a declared root (``thread-root-undeclared``
#: guards the harvest), and callback surfaces the call graph cannot
#: trace through a foreign loop (http.server handlers, functions
#: posted cross-thread via ``FrameServer.run_on_loop``) are declared
#: here directly.  Roles propagate through the call graph; a declared
#: root is PINNED — it keeps exactly its declared roles even when some
#: other role's code holds a reference to it (that is how a closure
#: posted to the loop thread stays loop-role despite being defined on
#: the sweep thread).  Module-level ``main`` functions are harvested
#: automatically as the ``main`` role: caller-context control-plane
#: code (CLIs, setup/stop paths, tests) that the conflict rules treat
#: as externally serialized — see tpumon_torch/docs/static_analysis.md.
THREAD_ROOTS: Dict[str, List[str]] = {
    # the watch sweep thread and the exporter sweep loop (one of them
    # drives collection; both tee into the recorder/stream publishers)
    "sweep": ["tpumon_torch/watch.py::WatchManager._run",
              "tpumon_torch/exporter/exporter.py::TpuExporter.run_forever"],
    # the frame server's single loop thread: owns every socket,
    # connection buffer and subscriber table; ConnHandler callbacks
    # (the Python agent's AgentHandler among them) and cross-thread
    # run_on_loop posts all land here
    "loop": ["tpumon_torch/frameserver.py::FrameServer._loop",
             "tpumon_torch/frameserver.py::FrameServer._enqueue",
             "tpumon_torch/frameserver.py::StreamPublisher._fanout",
             "tpumon_torch/frameserver.py::StreamPublisher._fanout_record",
             "tpumon_torch/frameserver.py::StreamPublisher"
             "._fanout_heartbeat"],
    # the fleet multiplexer tick (the CLI's foreground thread — a role
    # of its own because the poller's state is single-owner by design;
    # take_findings shares poll's single-owner contract, and the native
    # facade's poll() override inherits it)
    "fleet": ["tpumon_torch/fleetpoll.py::FleetPoller.poll",
              "tpumon_torch/fleetpoll.py::NativeFleetPoller.poll",
              "tpumon_torch/fleetpoll.py::FleetPoller.take_findings"],
    # the kernel-log tailer thread (sink callbacks run on it)
    "kmsg": ["tpumon_torch/kmsg.py::KmsgWatcher._run"],
    # the NVML backend's Xid event thread: blocks in
    # nvmlEventSetWait_v2 and appends to the event ring under
    # NvmlBackend._events_lock
    "nvmlevent": ["tpumon_torch/backends/nvml.py::NvmlBackend._event_loop"],
    # http.server worker threads: the call graph cannot see through
    # serve_forever, so the dispatch surfaces are declared directly —
    # the exporter's, the REST API's, the pod exporter's, the Python
    # agent's --prom-port and the relay CLI's --metrics-port
    "http": [
        "tpumon_torch/httputil.py::TextHTTPServer.__init__.Handler.do_GET",
        "tpumon_torch/exporter/exporter.py::MetricsHTTPServer.__init__"
        ".dispatch",
        "tpumon_torch/restapi/server.py::RestApi.dispatch",
        "tpumon_torch/exporter/pod_main.py::main.dispatch",
        "tpumon_torch/hostengine.py::_prom_dispatch.dispatch",
        "tpumon_torch/cli/relay.py::main.dispatch",
    ],
    # the trace engine's parse thread: a background capture's Kineto
    # result is analyzed off the sampling thread and published under
    # TraceEngine._lock.  The capture itself (open, window, close) runs
    # on the thread that calls sample()/poll()/capture_now() — the
    # sweep thread, or the workload's below
    "trace": ["tpumon_torch/trace.py::TraceEngine._parse"],
    # the runner's forced capture: opened on the workload's own thread
    # (the profiler records the ops of the thread that opens it) while
    # it keeps stepping, beside the exporter's sweep
    "loadcap": [
        "tpumon_torch/loadgen/run.py::run_window.capture_while_stepping"],
    # the probe warmup compiler
    "warmup": ["tpumon_torch/backends/probes.py::ProbeEngine.warmup"],
    # the per-shard poller thread of the hierarchical fleet: drives
    # one FleetPoller over its host subset and feeds the synthetic row
    # table the serve side (loop role) reads — shared state is under
    # FleetShard._lock on both sides
    "shard": ["tpumon_torch/fleetshard.py::FleetShard._run"],
    # the shard supervisor's health-watch thread: hello probes,
    # restart scheduling, circuit-breaker bookkeeping — shared child
    # state is under ShardSupervisor._lock
    "supervisor": ["tpumon_torch/supervisor.py::ShardSupervisor._run"],
    # the burst inner-loop thread (Python-plane BurstSampler): single
    # producer folding the cheap-counter subset into the accumulator
    # the sweep thread harvests via the accumulator-swap handoff — in
    # the exporter and in the Python agent alike
    "burst": ["tpumon_torch/burst.py::BurstSampler._run"],
    # the stream relay's reader thread: owns the upstream socket and
    # the decoder mirror, drives the publisher's forward path — the
    # downstream fan-out itself runs on the frame server's loop role
    "relay": ["tpumon_torch/relay.py::StreamRelay._run"],
    # the simulated-subscriber farm's selector thread (bench/tests)
    "subfarm": ["tpumon_torch/agentsim.py::SubscriberFarm._loop"],
    # CLI-local helper threads (diag evidence load)
    "diagload": ["tpumon_torch/cli/diag.py::_EvidenceLoad.start.run"],
}

#: the auto-harvested caller-context role (module-level ``main``
#: functions): excluded from cross-role conflicts by design
MAIN_ROLE = "main"


@dataclass(frozen=True)
class HotProperty:
    """One reachability-scoped property: the rule, the legacy lint rule
    whose pragmas it honors, the root groups whose closure it checks,
    and the legacy filename scope kept as a parity cross-check."""

    rule: str
    lint_alias: str
    groups: Tuple[str, ...]
    legacy_prefixes: Tuple[str, ...]
    legacy_files: FrozenSet[str]


#: legacy scopes imported from the linter (single source — a scope
#: change there is a scope change here; the parity test compares the
#: two tools' coverage over exactly these sets).  The bootstrap path
#: insert keeps `python tpumon_torch/tools/tpumon_check.py` working
#: alongside `python -m tpumon_torch.tools.tpumon_check`.
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)
from tpumon_torch.tools.tpumon_lint import (  # noqa: E402
    _BLACKBOX_FILES, _FLEETPOLL_FILES, _HOT_TEXT_FILES,
    _SAMPLING_FILES, _SAMPLING_PREFIXES, _SWEEP_JSON_FILES, PKG,
    TOOLS_DIR, setblocking_pinned_nonblocking)

#: the port's native tree (skipping its ``build``), and the file a
#: broken manifest entry is reported against
NATIVE_DIR = PKG + "/native"
BLACKBOX_DOC = PKG + "/docs/blackbox.md"
#: the codec extension pass 4 asks for its exported constants
CODEC_EXTENSION = "_tpumon_torch_codec"
CODEC_MODULE_SRC = NATIVE_DIR + "/codec/module.cc"
MANIFEST_FILE = TOOLS_DIR + "/tpumon_check.py"

PROPERTIES: Tuple[HotProperty, ...] = (
    HotProperty("hot-blocking-socket", "blocking-socket-in-fleetpoll",
                ("fleet", "stream", "shard", "burst", "relay"), (),
                _FLEETPOLL_FILES),
    HotProperty("hot-wallclock", "wallclock-in-sampling",
                _ALL_GROUPS, _SAMPLING_PREFIXES, _SAMPLING_FILES),
    HotProperty("hot-json", "json-in-sweep-path",
                _ALL_GROUPS, (), _SWEEP_JSON_FILES),
    HotProperty("hot-encode", "encode-in-hot-path",
                ("exporter", "render", "stream", "burst", "anomaly",
                 "relay"),
                (), _HOT_TEXT_FILES),
    HotProperty("hot-fsync", "fsync-in-hot-path",
                ("blackbox",), (), _BLACKBOX_FILES),
)


@dataclass(frozen=True)
class Finding:
    path: str
    line: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule}: {self.message}"

    def as_dict(self) -> Dict[str, object]:
        return {"path": self.path, "line": self.line, "rule": self.rule,
                "message": self.message}


# -- suppressions --------------------------------------------------------------

#: pragmas are accepted behind ``#`` (Python) or ``//`` (C++) so the
#: native pass shares one suppression machinery with the Python passes
_DISABLE_RE = re.compile(
    r"(?:#|//)\s*tpumon-(check|lint):\s*disable=([A-Za-z0-9_,\- ]+)")

#: the thread-pass suppression idiom: ``# tpumon: thread-ok(reason)``.
#: The reason is MANDATORY (an empty pragma suppresses nothing) — the
#: race rules only yield to a written-down ownership argument, and the
#: reasons are inventoried in the ``--json`` artifact / baseline file
#: so every accepted race stays auditable.
_THREAD_OK_RE = re.compile(r"(?:#|//)\s*tpumon:\s*thread-ok\(([^()]*)\)")

#: the pass-5 and pass-6 suppression idioms — same shape as
#: ``thread-ok``: the reason is MANDATORY and inventoried in the
#: baseline, so every accepted leak/effect stays auditable
_CLOSE_OK_RE = re.compile(r"(?:#|//)\s*tpumon:\s*close-ok\(([^()]*)\)")
_EFFECT_OK_RE = re.compile(r"(?:#|//)\s*tpumon:\s*effect-ok\(([^()]*)\)")
#: the hot-python-codec suppression idiom — the facade fallback
#: branches are the legitimate (and intended-to-be-only) callers of
#: the pure-Python codec implementations; each such site carries a
#: reasoned pragma, counted in the baseline like the other kinds
_CODEC_OK_RE = re.compile(r"(?:#|//)\s*tpumon:\s*codec-ok\(([^()]*)\)")


class Suppressions:
    """Per-line pragmas for one file.  ``tpumon-check`` pragmas apply
    to this tool's rule names; ``tpumon-lint`` pragmas apply through
    the twin-rule aliases, so the hot-path rules honor every pragma the
    legacy filename-scoped rules already carry.  ``tpumon:
    thread-ok(reason)`` suppresses every ``thread-*`` rule on that
    line (or the whole function from its ``def`` header);
    ``close-ok(reason)`` does the same for the exception-flow /
    resource-lifetime rules and ``effect-ok(reason)`` for the
    effect-budget rule — reasons required in all three."""

    def __init__(self, src: str) -> None:
        self._check: Dict[int, Set[str]] = {}
        self._lint: Dict[int, Set[str]] = {}
        self._thread_ok: Dict[int, str] = {}
        self._close_ok: Dict[int, str] = {}
        self._effect_ok: Dict[int, str] = {}
        self._codec_ok: Dict[int, str] = {}
        for i, line in enumerate(src.splitlines(), start=1):
            for m in _DISABLE_RE.finditer(line):
                rules = {r.strip() for r in m.group(2).split(",")
                         if r.strip()}
                tgt = self._check if m.group(1) == "check" else self._lint
                tgt.setdefault(i, set()).update(rules)
            for regex, store in ((_THREAD_OK_RE, self._thread_ok),
                                 (_CLOSE_OK_RE, self._close_ok),
                                 (_EFFECT_OK_RE, self._effect_ok),
                                 (_CODEC_OK_RE, self._codec_ok)):
                for m in regex.finditer(line):
                    reason = m.group(1).strip()
                    if reason:
                        store[i] = reason

    def _pragma_store(self, rule: str) -> Optional[Dict[int, str]]:
        if rule.startswith("thread-"):
            return self._thread_ok
        if rule in _CLOSE_OK_RULES or rule == "raii-lifetime":
            return self._close_ok
        if rule in ("effect-budget", "native-effect-budget"):
            return self._effect_ok
        if rule == "hot-python-codec":
            return self._codec_ok
        return None

    def suppressed(self, rule: str, lint_alias: Optional[str],
                   *lines: int) -> bool:
        store = self._pragma_store(rule)
        for ln in lines:
            if rule in self._check.get(ln, ()):
                return True
            if lint_alias and lint_alias in self._lint.get(ln, ()):
                return True
            if store is not None and ln in store:
                return True
        return False

    def thread_ok_reasons(self) -> Dict[int, str]:
        """line -> reason for every ``thread-ok`` pragma (the
        suppression inventory the baseline file audits)."""

        return dict(self._thread_ok)

    def reason_pragmas(self) -> Dict[str, Dict[int, str]]:
        """kind -> {line: reason} for every mandatory-reason pragma —
        the full suppression inventory the baseline file audits."""

        return {"thread-ok": dict(self._thread_ok),
                "close-ok": dict(self._close_ok),
                "effect-ok": dict(self._effect_ok),
                "codec-ok": dict(self._codec_ok)}

    def disable_pragmas(self) -> Dict[str, Dict[int, str]]:
        """kind -> {line: rules} for every ``tpumon-check: disable=`` and
        ``tpumon-lint: disable=`` pragma — the rule list stands in for
        the reason, so the baseline counts these suppressions too."""

        return {"check-disable": {ln: ",".join(sorted(r))
                                  for ln, r in self._check.items()},
                "lint-disable": {ln: ",".join(sorted(r))
                                 for ln, r in self._lint.items()}}


def _def_header_lines(fn: ast.AST) -> Tuple[int, ...]:
    body = getattr(fn, "body", None)
    first_body = body[0].lineno if body else fn.lineno + 1  # type: ignore[attr-defined]
    return tuple(range(fn.lineno, first_body))  # type: ignore[attr-defined]


# -- repo model ----------------------------------------------------------------

@dataclass
class FuncInfo:
    qname: str                      # "rel/path.py::Qual.name"
    rel: str
    name: str
    node: ast.AST                   # FunctionDef | AsyncFunctionDef
    cls: Optional[str] = None       # owning class qname
    def_lines: Tuple[int, ...] = ()
    #: resolved call edges: callee qname -> [line, ...]
    edges: Dict[str, List[int]] = dc_field(default_factory=dict)
    #: lock ids acquired lexically: [(lock, line, held-before)], in
    #: source order with the locks held at that point
    acquires: List[Tuple[str, int, Tuple[str, ...]]] = \
        dc_field(default_factory=list)
    #: blocking call sites: [(line, end_line, what, held-at-site)]
    blocking: List[Tuple[int, int, str, Tuple[str, ...]]] = \
        dc_field(default_factory=list)
    #: call sites with the locks held lexically at them
    calls_held: List[Tuple[str, Tuple[str, ...]]] = \
        dc_field(default_factory=list)
    #: nested-def definition edges ("defining may call"): part of the
    #: MAY lock analysis and role propagation, but excluded from the
    #: MUST guarded-by join — a closure runs where it is CALLED, and a
    #: def site outside the lock must not erase the guard its real
    #: call sites hold
    def_edges_held: List[Tuple[str, Tuple[str, ...]]] = \
        dc_field(default_factory=list)
    #: ``self.attr`` data reads: [(attr, line, held-at-site)]
    attr_reads: List[Tuple[str, int, Tuple[str, ...]]] = \
        dc_field(default_factory=list)
    #: ``self.attr`` writes: [(attr, line, held-at-site, kind)] where
    #: kind is "assign" (reference rebind) or "mutate" (in-place
    #: container/augmented update — the torn-read hazard)
    attr_writes: List[Tuple[str, int, Tuple[str, ...], str]] = \
        dc_field(default_factory=list)
    #: ``threading.Thread(target=...)`` spawns: [(line, resolved
    #: target qnames)] — the thread-root harvest
    thread_spawns: List[Tuple[int, Tuple[str, ...]]] = \
        dc_field(default_factory=list)
    #: explicit ``raise Name(...)`` sites: [(line, exception name,
    #: names caught by enclosing try handlers at the site)]
    raises: List[Tuple[int, str, Tuple[str, ...]]] = \
        dc_field(default_factory=list)
    #: call sites with the exception names caught around them:
    #: [(callee, line, caught)] — the raise-set propagation filter
    calls_caught: List[Tuple[str, int, Tuple[str, ...]]] = \
        dc_field(default_factory=list)


@dataclass
class ClassInfo:
    qname: str                      # "rel/path.py::Qual"
    rel: str
    name: str
    node: ast.ClassDef
    base_names: List[ast.expr] = dc_field(default_factory=list)
    bases: List[str] = dc_field(default_factory=list)     # resolved qnames
    subclasses: List[str] = dc_field(default_factory=list)
    methods: Dict[str, str] = dc_field(default_factory=dict)  # name -> fq
    #: attr -> class qname or EXTERNAL (from annotations/constructor
    #: assignments anywhere in the class)
    attr_types: Dict[str, str] = dc_field(default_factory=dict)
    #: attr -> "Lock" | "RLock" for threading locks created on self
    lock_attrs: Dict[str, str] = dc_field(default_factory=dict)
    #: attrs holding other synchronization primitives (Event,
    #: Condition, Semaphore, Queue): thread-safe by design, excluded
    #: from the guarded-by conflict analysis
    sync_attrs: Set[str] = dc_field(default_factory=set)
    #: attr -> kind ("selector" | "socket" | repo class name) for
    #: thread-AFFINE objects: owned by one thread, never shared
    affine_attrs: Dict[str, str] = dc_field(default_factory=dict)


@dataclass
class ModuleInfo:
    rel: str
    modname: str                    # "tpumon_torch.exporter.exporter"
    tree: ast.Module
    src: str
    supp: Suppressions
    #: module-scope name bindings: name -> ("class"|"func"|"module"|
    #: "ext", payload)
    binds: Dict[str, Tuple[str, str]] = dc_field(default_factory=dict)
    lock_globals: Dict[str, str] = dc_field(default_factory=dict)


@dataclass
class Graph:
    repo: str
    modules: Dict[str, ModuleInfo] = dc_field(default_factory=dict)
    funcs: Dict[str, FuncInfo] = dc_field(default_factory=dict)
    classes: Dict[str, ClassInfo] = dc_field(default_factory=dict)
    by_modname: Dict[str, str] = dc_field(default_factory=dict)
    #: method name -> [func qname, ...] (conservative-dispatch table)
    methods_by_name: Dict[str, List[str]] = dc_field(default_factory=dict)
    findings: List[Finding] = dc_field(default_factory=list)
    fallback_edges: int = 0
    resolved_edges: int = 0


def iter_python_files(repo: str) -> Iterator[str]:
    for root, dirs, files in os.walk(os.path.join(repo, PKG)):
        dirs[:] = [d for d in dirs if d != "__pycache__"
                   and os.path.join(root, d) != os.path.join(repo,
                                                             TOOLS_DIR)]
        for name in sorted(files):
            if name.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, name), repo)
                yield rel.replace(os.sep, "/")


def _modname(rel: str) -> str:
    parts = rel[:-3].split("/")          # strip .py
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


# -- indexing ------------------------------------------------------------------

_LOCK_CTORS = {"Lock": "Lock", "RLock": "RLock"}


def _lock_kind(value: ast.expr) -> Optional[str]:
    """'Lock'/'RLock' when ``value`` is ``threading.[R]Lock()``."""

    if not isinstance(value, ast.Call):
        return None
    f = value.func
    if isinstance(f, ast.Attribute) and f.attr in _LOCK_CTORS:
        return _LOCK_CTORS[f.attr]
    if isinstance(f, ast.Name) and f.id in _LOCK_CTORS:
        return _LOCK_CTORS[f.id]
    return None


#: constructors whose values are synchronization primitives — safe to
#: touch from any thread, excluded from the guarded-by analysis
_SYNC_CTORS = frozenset({
    "Event", "Condition", "Semaphore", "BoundedSemaphore", "Barrier",
    "Queue", "SimpleQueue", "LifoQueue", "PriorityQueue",
})

#: external constructors whose values are thread-AFFINE: one owning
#: thread, not shareable by locking (a selector mid-select, a socket
#: mid-send have kernel-side state locks cannot protect)
_AFFINE_SOCKET_CTORS = frozenset({
    "socket", "socketpair", "create_connection", "create_server",
})

#: repo classes whose instances are thread-affine: the frame codec's
#: per-connection delta tables assume one reader/writer thread (both
#: the facades and the Py* reference implementations behind them; the
#: native handles additionally ENFORCE single ownership
#: with a busy flag that raises on concurrent entry)
_AFFINE_CLASS_NAMES = frozenset({
    "SweepFrameDecoder", "SweepFrameEncoder", "StreamDecoder",
    "PySweepFrameDecoder", "PySweepFrameEncoder",
    # the streaming detection engine is single-owner like the codec
    # handles it rides beside: one engine per monitored stream, driven
    # by that stream's owner thread (exporter sweep loop, fleet
    # poller, backtest); cross-thread feeds (exporter kmsg lines)
    # queue into the owner instead of touching the engine
    "AnomalyEngine",
})


def _ctor_name(value: ast.expr) -> Optional[str]:
    """Terminal constructor name of a ``Call`` value, else None."""

    if not isinstance(value, ast.Call):
        return None
    f = value.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def _affine_kind(value: ast.expr) -> Optional[str]:
    """'selector'/'socket' when ``value`` constructs one."""

    name = _ctor_name(value)
    if name is None:
        return None
    if name.endswith("Selector"):
        return "selector"
    if name in _AFFINE_SOCKET_CTORS:
        return "socket"
    return None


def _index_module(g: Graph, rel: str) -> None:
    path = os.path.join(g.repo, rel)
    with open(path, encoding="utf-8") as f:
        src = f.read()
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        g.findings.append(Finding(rel, e.lineno or 0, "parse-error",
                                  f"file does not parse: {e.msg}"))
        return
    mi = ModuleInfo(rel=rel, modname=_modname(rel), tree=tree, src=src,
                    supp=Suppressions(src))
    g.modules[rel] = mi
    g.by_modname[mi.modname] = rel

    def add_func(node: ast.AST, qual: str,
                 cls: Optional[str]) -> FuncInfo:
        q = f"{rel}::{qual}"
        fi = FuncInfo(qname=q, rel=rel, name=qual.rsplit(".", 1)[-1],
                      node=node, cls=cls,
                      def_lines=_def_header_lines(node))
        g.funcs[q] = fi
        return fi

    def walk_defs(body: Sequence[ast.AST], prefix: str,
                  cls: Optional[str]) -> None:
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{node.name}"
                add_func(node, qual, cls)
                # nested defs: the parent may call them
                walk_defs(node.body, qual + ".", cls)
            elif isinstance(node, (ast.stmt, ast.excepthandler)) and \
                    not isinstance(node, ast.ClassDef):
                # compound statements: a def nested inside with/if/
                # try/for is still a function of the enclosing scope
                inner = [s for s in ast.iter_child_nodes(node)
                         if isinstance(s, (ast.stmt, ast.excepthandler))]
                if inner:
                    walk_defs(inner, prefix, cls)
            elif isinstance(node, ast.ClassDef):
                qual = f"{prefix}{node.name}"
                ci = ClassInfo(qname=f"{rel}::{qual}", rel=rel,
                               name=node.name, node=node,
                               base_names=list(node.bases))
                g.classes[ci.qname] = ci
                for stmt in node.body:
                    if isinstance(stmt, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        mq = f"{qual}.{stmt.name}"
                        add_func(stmt, mq, ci.qname)
                        ci.methods[stmt.name] = f"{rel}::{mq}"
                        g.methods_by_name.setdefault(
                            stmt.name, []).append(f"{rel}::{mq}")
                        walk_defs(stmt.body, mq + ".", ci.qname)
                    elif isinstance(stmt, ast.ClassDef):
                        walk_defs([stmt], qual + ".", None)
                    # dataclass-style field annotations are resolved
                    # later by _collect_attr_types (imports must be
                    # bound first)

    walk_defs(tree.body, "", None)

    # module-scope bindings: defs, classes, module-level locks
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            mi.binds[node.name] = ("func", f"{rel}::{node.name}")
        elif isinstance(node, ast.ClassDef):
            mi.binds[node.name] = ("class", f"{rel}::{node.name}")
        elif isinstance(node, ast.Assign):
            kind = _lock_kind(node.value)
            if kind:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        mi.lock_globals[t.id] = kind


def _resolve_imports(g: Graph, mi: ModuleInfo) -> None:
    parts = mi.modname.split(".")
    is_pkg = mi.rel.endswith("__init__.py")
    for node in ast.walk(mi.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                name = alias.asname or alias.name.split(".")[0]
                target = alias.name if alias.asname else \
                    alias.name.split(".")[0]
                if target in g.by_modname or \
                        target.split(".")[0] in g.by_modname:
                    mi.binds[name] = ("module", target)
                else:
                    mi.binds[name] = ("ext", target)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = parts if is_pkg else parts[:-1]
                base = base[:len(base) - (node.level - 1)]
                src_mod = ".".join(base + ([node.module] if node.module
                                           else []))
            else:
                src_mod = node.module or ""
            for alias in node.names:
                name = alias.asname or alias.name
                sub = f"{src_mod}.{alias.name}"
                if sub in g.by_modname:
                    mi.binds[name] = ("module", sub)
                    continue
                src_rel = g.by_modname.get(src_mod)
                if src_rel is None:
                    mi.binds[name] = ("ext", f"{src_mod}.{alias.name}")
                    continue
                src_mi = g.modules[src_rel]
                bound = src_mi.binds.get(alias.name)
                if bound is not None and bound[0] in ("class", "func",
                                                      "module"):
                    mi.binds[name] = bound
                else:
                    mi.binds[name] = ("other", f"{src_mod}.{alias.name}")


def _resolve_bases(g: Graph) -> None:
    for ci in g.classes.values():
        mi = g.modules[ci.rel]
        for b in ci.base_names:
            q = _resolve_class_expr(g, mi, b)
            if q and q in g.classes:
                ci.bases.append(q)
                g.classes[q].subclasses.append(ci.qname)


def _resolve_class_expr(g: Graph, mi: ModuleInfo,
                        node: ast.expr) -> Optional[str]:
    """Resolve an expression naming a class (base list, annotation) to
    a repo class qname, EXTERNAL for known non-repo names, or None."""

    if isinstance(node, ast.Name):
        bound = mi.binds.get(node.id)
        if bound is None:
            return None
        if bound[0] == "class":
            return bound[1]
        if bound[0] == "ext":
            return EXTERNAL
        return None
    if isinstance(node, ast.Attribute):
        base = node.value
        if isinstance(base, ast.Name):
            bound = mi.binds.get(base.id)
            if bound is None:
                return None
            if bound[0] == "module":
                tgt_rel = g.by_modname.get(bound[1])
                if tgt_rel is None:
                    return EXTERNAL
                tb = g.modules[tgt_rel].binds.get(node.attr)
                if tb is not None and tb[0] == "class":
                    return tb[1]
                return None
            if bound[0] == "ext":
                return EXTERNAL
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        # string annotation: "tpumon_torch.Handle" — a generic suffix
        # ("subprocess.Popen[bytes]") names the same class; without
        # the strip the receiver falls back to name matching and a
        # Popen.poll() call grows edges to every repo .poll()
        return _resolve_dotted(g, mi,
                               node.value.split("[", 1)[0].strip())
    if isinstance(node, ast.Subscript):
        # Optional[T] / "T | None": unwrap one level
        base = node.value
        if isinstance(base, ast.Name) and base.id == "Optional":
            return _resolve_class_expr(g, mi, node.slice)
        # a parametrized class (List[T] aside, e.g. Popen[bytes] /
        # Queue[int]) types as the class itself; typing containers
        # resolve to None below, never to a repo class
        return _resolve_class_expr(g, mi, base)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.BitOr):
        left = _resolve_class_expr(g, mi, node.left)
        if left:
            return left
        return _resolve_class_expr(g, mi, node.right)
    return None


def _resolve_dotted(g: Graph, mi: ModuleInfo,
                    dotted: str) -> Optional[str]:
    dotted = dotted.strip()
    if not dotted:
        return None
    if "." in dotted:
        mod, _, name = dotted.rpartition(".")
        rel = g.by_modname.get(mod)
        if rel is not None:
            tb = g.modules[rel].binds.get(name)
            if tb is not None and tb[0] == "class":
                return tb[1]
            return None
        # the module half is imported but is NOT a repo module
        # ("subprocess.Popen"): the class provably lives outside the
        # repo — same EXTERNAL verdict the ast.Attribute branch gives
        # the unquoted spelling, so string annotations do not grow
        # name-fallback edges the direct ones would not
        head = dotted.split(".", 1)[0]
        hb = mi.binds.get(head)
        if hb is not None and (
                hb[0] == "ext"
                or (hb[0] == "module"
                    and g.by_modname.get(hb[1]) is None)):
            return EXTERNAL
    bound = mi.binds.get(dotted)
    if bound is not None and bound[0] == "class":
        return bound[1]
    return None


def _collect_attr_types(g: Graph) -> None:
    """attr -> type for every class, from annotations and
    ``self.X = ClassName(...)`` assignments in any method."""

    for ci in g.classes.values():
        mi = g.modules[ci.rel]
        for mname, fq in ci.methods.items():
            fi = g.funcs.get(fq)
            if fi is None:
                continue
            params = _param_types(g, mi, ci, fi)
            for node in ast.walk(fi.node):  # includes nested defs: fine
                if isinstance(node, ast.AnnAssign) and \
                        isinstance(node.target, ast.Attribute) and \
                        isinstance(node.target.value, ast.Name) and \
                        node.target.value.id == "self":
                    t = _resolve_class_expr(g, mi, node.annotation)
                    if t:
                        _merge_attr(ci, node.target.attr, t)
                        _note_affine(ci, node.target.attr, t)
                    if node.value is not None:
                        k = _lock_kind(node.value)
                        if k:
                            ci.lock_attrs[node.target.attr] = k
                        _classify_attr_value(ci, node.target.attr,
                                             node.value)
                elif isinstance(node, ast.Assign):
                    k = _lock_kind(node.value)
                    t = _infer_simple(g, mi, ci, params, node.value)
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Attribute) and \
                                isinstance(tgt.value, ast.Name) and \
                                tgt.value.id == "self":
                            if k:
                                ci.lock_attrs[tgt.attr] = k
                            if t:
                                _merge_attr(ci, tgt.attr, t)
                                _note_affine(ci, tgt.attr, t)
                            _classify_attr_value(ci, tgt.attr,
                                                 node.value)
                        elif isinstance(tgt, ast.Tuple):
                            # self._r, self._w = socket.socketpair()
                            kind = _affine_kind(node.value)
                            if kind is None:
                                continue
                            for el in tgt.elts:
                                if isinstance(el, ast.Attribute) and \
                                        isinstance(el.value, ast.Name) \
                                        and el.value.id == "self":
                                    ci.affine_attrs.setdefault(el.attr,
                                                               kind)
        # dataclass field annotations (class body)
        for stmt in ci.node.body:
            if isinstance(stmt, ast.AnnAssign) and \
                    isinstance(stmt.target, ast.Name):
                t = _resolve_class_expr(g, mi, stmt.annotation)
                if t:
                    _merge_attr(ci, stmt.target.id, t)


def _merge_attr(ci: ClassInfo, attr: str, t: str) -> None:
    prev = ci.attr_types.get(attr)
    if prev is None or (prev == EXTERNAL and t != EXTERNAL):
        ci.attr_types[attr] = t


def _note_affine(ci: ClassInfo, attr: str, t: str) -> None:
    """Mark ``attr`` affine when its resolved repo type is one of the
    affine codec classes."""

    if t != EXTERNAL:
        name = t.rsplit(".", 1)[-1]
        if name in _AFFINE_CLASS_NAMES:
            ci.affine_attrs.setdefault(attr, name)


def _classify_attr_value(ci: ClassInfo, attr: str,
                         value: ast.expr) -> None:
    """Record sync-primitive and affine-object constructor
    assignments for the thread pass."""

    name = _ctor_name(value)
    if name in _SYNC_CTORS:
        ci.sync_attrs.add(attr)
    kind = _affine_kind(value)
    if kind is not None:
        ci.affine_attrs.setdefault(attr, kind)


def _param_types(g: Graph, mi: ModuleInfo, ci: Optional[ClassInfo],
                 fi: FuncInfo) -> Dict[str, str]:
    """Parameter name -> class qname/EXTERNAL from annotations; binds
    ``self`` to the owning class."""

    out: Dict[str, str] = {}
    args = fi.node.args  # type: ignore[attr-defined]
    all_args = list(args.posonlyargs) + list(args.args) + \
        list(args.kwonlyargs)
    for a in all_args:
        if a.annotation is not None:
            t = _resolve_class_expr(g, mi, a.annotation)
            if t:
                out[a.arg] = t
    if ci is not None and all_args and all_args[0].arg == "self":
        out["self"] = ci.qname
    return out


def _infer_simple(g: Graph, mi: ModuleInfo, ci: Optional[ClassInfo],
                  env: Dict[str, str], node: ast.expr) -> Optional[str]:
    """Best-effort expression type: repo class qname, EXTERNAL, or
    None.  Handles names, one-or-more attribute hops through annotated
    attrs, constructor calls, and ``a or b`` defaulting."""

    if isinstance(node, ast.Name):
        t = env.get(node.id)
        if t:
            return t
        bound = mi.binds.get(node.id)
        if bound is not None and bound[0] == "ext":
            return EXTERNAL
        return None
    if isinstance(node, ast.Attribute):
        base_t = _infer_simple(g, mi, ci, env, node.value)
        if base_t and base_t != EXTERNAL:
            c = g.classes.get(base_t)
            while c is not None:
                t = c.attr_types.get(node.attr)
                if t:
                    return t
                c = g.classes.get(c.bases[0]) if c.bases else None
            return None
        if base_t == EXTERNAL:
            return EXTERNAL
        return None
    if isinstance(node, ast.Call):
        if isinstance(node.func, (ast.Name, ast.Attribute)):
            q = _resolve_class_expr(g, mi, node.func)
            if q and q != EXTERNAL:
                return q
        return None
    if isinstance(node, ast.BoolOp):
        for v in node.values:
            t = _infer_simple(g, mi, ci, env, v)
            if t:
                return t
    return None


# -- call extraction -----------------------------------------------------------

#: builtin container/IO method names excluded from the conservative
#: dynamic-dispatch fallback: an unresolved ``x.get()`` must not edge
#: into every repo class that happens to define ``get``
_FALLBACK_SKIP = frozenset({
    "append", "extend", "insert", "remove", "pop", "clear", "index",
    "count", "sort", "reverse", "copy", "get", "items", "keys",
    "values", "setdefault", "update", "popitem", "add", "discard",
    "union", "difference", "difference_update", "intersection",
    "issubset", "issuperset", "split", "rsplit", "join", "strip",
    "lstrip", "rstrip", "startswith", "endswith", "replace", "find",
    "rfind", "lower", "upper", "format", "encode", "decode",
    "splitlines", "partition", "rpartition", "zfill", "hex",
    "to_bytes", "from_bytes", "read", "write", "readline",
    "readlines", "seek", "tell", "fileno", "close", "flush", "open",
    "send", "recv", "recv_into", "sendall", "accept", "connect",
    "connect_ex", "settimeout", "setblocking", "getsockopt",
    "setsockopt", "bind", "listen", "shutdown", "makefile",
    "register", "unregister", "modify", "select", "acquire",
    "release", "wait", "set", "is_set", "notify", "notify_all",
    "join", "start", "cancel", "match", "search", "finditer",
    "findall", "group", "groups", "sub", "fullmatch", "total_seconds",
    "mro", "put", "task_done", "popleft", "appendleft", "isoformat",
})

#: container methods that mutate their receiver in place — a
#: ``self.attr.<m>(...)`` call is a write site of ``attr`` for the
#: guarded-by analysis, of the multi-step ("mutate") kind a concurrent
#: reader can observe half-applied
_MUTATOR_METHODS = frozenset({
    "append", "extend", "insert", "remove", "pop", "popitem", "clear",
    "update", "setdefault", "add", "discard", "appendleft", "popleft",
    "sort", "reverse",
})

_LOCKISH_RE = re.compile(r"lock", re.IGNORECASE)


def _handler_reraises(h: ast.ExceptHandler) -> bool:
    """True when the handler body contains a bare ``raise`` (outside
    nested function scopes): the caught exception leaves the function
    anyway, so this handler must not count as catching it."""

    stack: List[ast.AST] = list(h.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        if isinstance(node, ast.Raise) and node.exc is None:
            return True
        stack.extend(ast.iter_child_nodes(node))
    return False


def _handler_names(node: ast.Try) -> Tuple[str, ...]:
    """Exception names a ``try``'s handlers catch AND swallow.  A bare
    ``except:`` contributes ``BaseException`` (catches everything);
    tuples flatten; dotted types keep their terminal name; a handler
    that re-raises (bare ``raise`` — the log-and-reraise idiom) does
    not count as catching at all, so the exception still propagates
    through the raise-set fixpoint and the no-raise effect budgets."""

    names: List[str] = []
    for h in node.handlers:
        if _handler_reraises(h):
            continue
        t = h.type
        if t is None:
            names.append("BaseException")
            continue
        parts = t.elts if isinstance(t, ast.Tuple) else [t]
        for p in parts:
            if isinstance(p, ast.Name):
                names.append(p.id)
            elif isinstance(p, ast.Attribute):
                names.append(p.attr)
    return tuple(names)


def _lockish_name(expr: ast.expr) -> Optional[Tuple[str, str]]:
    """('self'|'name', attr/name) when the expression looks like a
    lock (terminal name contains 'lock'); unwraps calls."""

    if isinstance(expr, ast.Call):
        return _lockish_name(expr.func)
    if isinstance(expr, ast.Attribute):
        if _LOCKISH_RE.search(expr.attr):
            base = "self" if (isinstance(expr.value, ast.Name)
                              and expr.value.id == "self") else "?"
            return base, expr.attr
        return None
    if isinstance(expr, ast.Name) and _LOCKISH_RE.search(expr.id):
        return "name", expr.id
    return None


def _lock_id(g: Graph, mi: ModuleInfo, ci: Optional[ClassInfo],
             fi: FuncInfo, expr: ast.expr) -> Optional[str]:
    """Identify a ``with`` context expression as a lock.  Registered
    locks (a ``threading.[R]Lock()`` assigned to a module global or a
    ``self`` attribute) are recognized by identity whatever their
    name; otherwise anything whose terminal name contains 'lock' is
    tracked heuristically."""

    target = expr.func if isinstance(expr, ast.Call) else expr
    # registry first: names that ARE locks, however they are spelled
    if isinstance(target, ast.Attribute) and \
            isinstance(target.value, ast.Name) and \
            target.value.id == "self" and ci is not None:
        c: Optional[ClassInfo] = ci
        while c is not None:
            if target.attr in c.lock_attrs:
                return f"{c.qname}.{target.attr}"
            c = g.classes.get(c.bases[0]) if c.bases else None
    elif isinstance(target, ast.Name) and target.id in mi.lock_globals:
        return f"{mi.rel}::{target.id}"
    # heuristic fallback: lockish names without a visible constructor
    ln = _lockish_name(expr)
    if ln is None:
        return None
    base, name = ln
    if base == "self" and ci is not None:
        return f"{ci.qname}.{name}"
    return f"{fi.qname}::{name}"          # local/unknown: distinct id


class _CallWalker:
    """Per-function walk: resolves call edges, collects lock
    acquisitions, blocking sites and lexical held sets."""

    def __init__(self, g: Graph, mi: ModuleInfo, fi: FuncInfo) -> None:
        self.g = g
        self.mi = mi
        self.fi = fi
        self.ci = g.classes.get(fi.cls) if fi.cls else None
        self.env = _param_types(g, mi, self.ci, fi)
        #: exception names caught by enclosing try handlers at the
        #: statement being walked (raise-set propagation filter)
        self.caught: Tuple[str, ...] = ()

    def run(self) -> None:
        for stmt in self.fi.node.body:  # type: ignore[attr-defined]
            self._stmt(stmt, ())

    # -- statement walk with held-lock tracking --

    def _stmt(self, node: ast.stmt, held: Tuple[str, ...]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested def: the parent may call it (edge), but its body is
            # walked as its own function.  The held set travels with
            # the edge — a closure defined under a lock runs under it
            q = self._nested_qname(node)
            if q:
                self._edge(q, node.lineno, held, is_def=True)
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            new_held = held
            for item in node.items:
                # later items evaluate AFTER earlier locks are taken:
                # `with self._lock, sock.makefile():` blocks under the
                # lock, so the context expr sees the running held set
                self._expr(item.context_expr, new_held)
                lid = _lock_id(self.g, self.mi, self.ci, self.fi,
                               item.context_expr)
                if lid is not None:
                    self.fi.acquires.append(
                        (lid, item.context_expr.lineno, new_held))
                    new_held = new_held + (lid,)
            for s in node.body:
                self._stmt(s, new_held)
            return
        if isinstance(node, ast.Assign):
            self._expr(node.value, held)
            t = _infer_simple(self.g, self.mi, self.ci, self.env,
                              node.value)
            for tgt in node.targets:
                self._write_target(tgt, held)
                self._bind_target(tgt, t, node.value)
            return
        if isinstance(node, ast.AugAssign):
            self._expr(node.value, held)
            self._write_target(node.target, held, mutate=True)
            return
        if isinstance(node, ast.Delete):
            for tgt in node.targets:
                self._write_target(tgt, held, mutate=True)
            return
        if isinstance(node, ast.AnnAssign):
            if node.value is not None:
                self._expr(node.value, held)
                # a bare `self.x: T` (no value) declares, not writes
                self._write_target(node.target, held)
            t = _resolve_class_expr(self.g, self.mi, node.annotation)
            if isinstance(node.target, ast.Name) and t:
                self.env[node.target.id] = t
            return
        if isinstance(node, ast.Try):
            # calls in the try body run under this try's handlers —
            # exceptions they raise that the handlers match do not
            # escape this function (the raise-set propagation filter)
            outer = self.caught
            self.caught = outer + _handler_names(node)
            for s in node.body:
                self._stmt(s, held)
            self.caught = outer
            for h in node.handlers:
                if h.type is not None:
                    self._expr(h.type, held)
                for s in h.body:
                    self._stmt(s, held)
            # else runs after the body completed without raising: its
            # exceptions are NOT caught by this try's handlers
            for s in node.orelse:
                self._stmt(s, held)
            for s in node.finalbody:
                self._stmt(s, held)
            return
        if isinstance(node, ast.Raise):
            if node.exc is not None:
                self._expr(node.exc, held)
                name = _ctor_name(node.exc) or (
                    node.exc.id if isinstance(node.exc, ast.Name)
                    else "")
                if name:
                    self.fi.raises.append(
                        (node.lineno, name, self.caught))
            if node.cause is not None:
                self._expr(node.cause, held)
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.stmt):
                self._stmt(child, held)
            elif isinstance(child, ast.expr):
                self._expr(child, held)
            elif isinstance(child, (ast.excepthandler,)):
                for s in child.body:
                    self._stmt(s, held)

    def _write_target(self, tgt: ast.expr, held: Tuple[str, ...],
                      mutate: bool = False) -> None:
        """Record ``self.attr`` write sites: plain rebinds
        (``self.x = v``), in-place updates (``self.x += v``,
        ``self.d[k] = v``, ``del self.d[k]``) and tuple unpacks."""

        if isinstance(tgt, ast.Attribute) and \
                isinstance(tgt.value, ast.Name) and tgt.value.id == "self":
            self.fi.attr_writes.append(
                (tgt.attr, tgt.lineno, held,
                 "mutate" if mutate else "assign"))
        elif isinstance(tgt, ast.Subscript):
            base = tgt.value
            if isinstance(base, ast.Attribute) and \
                    isinstance(base.value, ast.Name) and \
                    base.value.id == "self":
                # self.d[k] = v is an in-place mutation OF d
                self.fi.attr_writes.append(
                    (base.attr, tgt.lineno, held, "mutate"))
            self._expr(tgt.slice, held)
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._write_target(el, held, mutate=mutate)
        elif isinstance(tgt, ast.Starred):
            self._write_target(tgt.value, held, mutate=mutate)

    def _bind_target(self, tgt: ast.expr, t: Optional[str],
                     value: ast.expr) -> None:
        if isinstance(tgt, ast.Name) and t:
            self.env[tgt.id] = t
        elif isinstance(tgt, (ast.Tuple, ast.List)) and \
                isinstance(value, (ast.Tuple, ast.List)) and \
                len(tgt.elts) == len(value.elts):
            for te, ve in zip(tgt.elts, value.elts):
                tt = _infer_simple(self.g, self.mi, self.ci, self.env, ve)
                self._bind_target(te, tt, ve)

    def _nested_qname(self, node: ast.AST) -> Optional[str]:
        return self._nested_qname_by_name(node.name)  # type: ignore[attr-defined]

    def _nested_qname_by_name(self, name: str) -> Optional[str]:
        prefix = self.fi.qname.split("::", 1)[1]
        q = f"{self.fi.rel}::{prefix}.{name}"
        return q if q in self.g.funcs else None

    # -- thread-root harvest --

    def _is_thread_ctor(self, f: ast.expr) -> bool:
        if isinstance(f, ast.Attribute):
            return f.attr == "Thread" and \
                isinstance(f.value, ast.Name) and f.value.id == "threading"
        if isinstance(f, ast.Name) and f.id == "Thread":
            bound = self.mi.binds.get("Thread")
            return bound is not None and bound[0] == "ext" and \
                bound[1].startswith("threading")
        return False

    def _harvest_thread_target(self, node: ast.Call) -> None:
        """Resolve a ``threading.Thread(target=...)`` spawn to repo
        functions; unresolvable targets (an external callable like
        ``self.server.serve_forever``) are not recorded."""

        for kw in node.keywords:
            if kw.arg != "target":
                continue
            v = kw.value
            targets: List[str] = []
            if isinstance(v, ast.Attribute) and \
                    isinstance(v.value, ast.Name) and \
                    v.value.id == "self" and self.ci is not None:
                targets = self._virtual_targets(self.ci, v.attr)
            elif isinstance(v, ast.Name):
                q = self._nested_qname_by_name(v.id)
                if q is not None:
                    targets = [q]
                else:
                    bound = self.mi.binds.get(v.id)
                    if bound is not None and bound[0] == "func":
                        targets = [bound[1]]
            elif isinstance(v, ast.Attribute) and \
                    isinstance(v.value, ast.Name):
                bound = self.mi.binds.get(v.value.id)
                if bound is not None and bound[0] == "module":
                    rel = self.g.by_modname.get(bound[1])
                    if rel is not None:
                        tb = self.g.modules[rel].binds.get(v.attr)
                        if tb is not None and tb[0] == "func":
                            targets = [tb[1]]
            if targets:
                self.fi.thread_spawns.append(
                    (node.lineno, tuple(sorted(targets))))

    # -- expression walk --

    def _expr(self, node: ast.expr, held: Tuple[str, ...]) -> None:
        # ast.walk also descends into lambda bodies: their calls are
        # attributed to the defining function (conservative)
        skip: Set[int] = set()
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                self._call(sub, held)
                f = sub.func
                if isinstance(f, ast.Attribute) and \
                        isinstance(f.value, ast.Name) and \
                        f.value.id == "self":
                    # self.method(...): a code reference, not a data
                    # read (the call edge covers it)
                    skip.add(id(f))
                elif isinstance(f, ast.Attribute) and \
                        f.attr in _MUTATOR_METHODS and \
                        isinstance(f.value, ast.Attribute) and \
                        isinstance(f.value.value, ast.Name) and \
                        f.value.value.id == "self":
                    # self.attr.append(...): _call records this site
                    # as a 'mutate' WRITE — harvesting the receiver
                    # as a read too would double-report the site
                    skip.add(id(f.value))
        for sub in ast.walk(node):
            if isinstance(sub, ast.Attribute) and id(sub) not in skip \
                    and isinstance(sub.value, ast.Name) and \
                    sub.value.id == "self" and \
                    isinstance(sub.ctx, ast.Load):
                self.fi.attr_reads.append((sub.attr, sub.lineno, held))

    def _edge(self, callee: str, line: int,
              held: Tuple[str, ...] = (), is_def: bool = False) -> None:
        self.fi.edges.setdefault(callee, []).append(line)
        if is_def:
            self.fi.def_edges_held.append((callee, held))
        else:
            self.fi.calls_held.append((callee, held))
            self.fi.calls_caught.append((callee, line, self.caught))
        self.g.resolved_edges += 1

    def _call(self, node: ast.Call, held: Tuple[str, ...]) -> None:
        f = node.func
        g = self.g
        self._check_blocking(node, held)
        if self._is_thread_ctor(f):
            self._harvest_thread_target(node)
        if isinstance(f, ast.Attribute) and f.attr in _MUTATOR_METHODS:
            recv = f.value
            if isinstance(recv, ast.Attribute) and \
                    isinstance(recv.value, ast.Name) and \
                    recv.value.id == "self":
                # self.d.update(...)-style in-place mutation
                self.fi.attr_writes.append(
                    (recv.attr, node.lineno, held, "mutate"))
        if isinstance(f, ast.Name):
            # a direct call to a nested def of this function resolves
            # with the held set at the CALL site — that is how
            # "caller holds the lock" helpers keep their guard in the
            # must-hold join
            nq = self._nested_qname_by_name(f.id)
            if nq is not None:
                self._edge(nq, node.lineno, held)
                return
            # other local-variable call targets (`fn = self.helper;
            # fn()`) are NOT resolved — only module-scope names are
            bound = self.mi.binds.get(f.id)
            if bound is None:
                return
            kind, payload = bound
            if kind == "func":
                self._edge(payload, node.lineno, held)
            elif kind == "class":
                ci = g.classes.get(payload)
                if ci is not None:
                    init = self._find_method(ci, "__init__")
                    if init:
                        self._edge(init, node.lineno, held)
            return
        if not isinstance(f, ast.Attribute):
            return
        attr = f.attr
        base = f.value
        # super().method(): resolve up the base-class chain from the
        # ENCLOSING class — without this, the conservative fallback
        # would edge an override's delegation into every repo class
        # that happens to define the same method name
        if isinstance(base, ast.Call) and \
                isinstance(base.func, ast.Name) and \
                base.func.id == "super" and self.ci is not None:
            parent = g.classes.get(self.ci.bases[0]) \
                if self.ci.bases else None
            m = self._find_method(parent, attr)
            if m:
                self._edge(m, node.lineno, held)
            return
        # self.method()
        if isinstance(base, ast.Name) and base.id == "self" and \
                self.ci is not None:
            targets = self._virtual_targets(self.ci, attr)
            if targets:
                for t in targets:
                    self._edge(t, node.lineno, held)
                return
            # self.attr where attr holds a known instance? fall through
        # module.func() / Class.method() / typed_obj.method()
        owner: Optional[str] = None
        if isinstance(base, ast.Name):
            bound = self.mi.binds.get(base.id)
            if bound is not None:
                kind, payload = bound
                if kind == "module":
                    rel = g.by_modname.get(payload)
                    if rel is not None:
                        tb = g.modules[rel].binds.get(attr)
                        if tb is not None and tb[0] == "func":
                            self._edge(tb[1], node.lineno, held)
                        elif tb is not None and tb[0] == "class":
                            ci = g.classes.get(tb[1])
                            init = self._find_method(ci, "__init__") \
                                if ci else None
                            if init:
                                self._edge(init, node.lineno, held)
                    return
                if kind == "class":
                    ci = g.classes.get(payload)
                    if ci is not None:
                        m = self._find_method(ci, attr)
                        if m:
                            self._edge(m, node.lineno, held)
                            return
                if kind == "ext":
                    return
            owner = self.env.get(base.id)
        if owner is None:
            owner = _infer_simple(g, self.mi, self.ci, self.env, base)
        if owner == EXTERNAL:
            return
        if owner is not None:
            ci = g.classes.get(owner)
            if ci is not None:
                targets = self._virtual_targets(ci, attr)
                if targets:
                    for t in targets:
                        self._edge(t, node.lineno, held)
                    return
        # conservative dynamic-dispatch fallback
        if attr in _FALLBACK_SKIP:
            return
        for t in g.methods_by_name.get(attr, ()):
            self._edge(t, node.lineno, held)
            g.fallback_edges += 1

    def _find_method(self, ci: Optional[ClassInfo],
                     name: str) -> Optional[str]:
        seen = set()
        while ci is not None and ci.qname not in seen:
            seen.add(ci.qname)
            m = ci.methods.get(name)
            if m:
                return m
            ci = self.g.classes.get(ci.bases[0]) if ci.bases else None
        return None

    def _virtual_targets(self, ci: ClassInfo, name: str) -> List[str]:
        """The method on ``ci`` (or an ancestor) plus every subclass
        override — conservative virtual dispatch."""

        out: List[str] = []
        base = self._find_method(ci, name)
        if base:
            out.append(base)
        stack = list(ci.subclasses)
        seen: Set[str] = set()
        while stack:
            q = stack.pop()
            if q in seen:
                continue
            seen.add(q)
            sub = self.g.classes.get(q)
            if sub is None:
                continue
            m = sub.methods.get(name)
            if m and m not in out:
                out.append(m)
            stack.extend(sub.subclasses)
        return out

    # -- blocking-call detection --

    _BLOCKING_ATTRS = frozenset({
        "accept", "sendall", "makefile", "connect", "readline",
        "flush", "fsync", "fdatasync",
    })
    _SUBPROCESS_FUNCS = frozenset({
        "run", "call", "check_call", "check_output", "Popen",
    })

    def _check_blocking(self, node: ast.Call,
                        held: Tuple[str, ...]) -> None:
        f = node.func
        what: Optional[str] = None
        if isinstance(f, ast.Attribute):
            base = f.value
            if f.attr == "sleep" and isinstance(base, ast.Name) and \
                    base.id == "time":
                what = "time.sleep()"
            elif f.attr in ("fsync", "fdatasync") and \
                    isinstance(base, ast.Name) and base.id == "os":
                what = f"os.{f.attr}()"
            elif isinstance(base, ast.Name) and base.id == "subprocess" \
                    and f.attr in self._SUBPROCESS_FUNCS:
                what = f"subprocess.{f.attr}()"
            elif f.attr in self._BLOCKING_ATTRS:
                # skip receivers proven external-and-nonblocking is not
                # possible statically; but a str/bytes literal receiver
                # (".".join style) is never a blocking handle
                if not isinstance(base, ast.Constant):
                    what = f".{f.attr}()"
        if what is not None:
            self.fi.blocking.append(
                (node.lineno, node.end_lineno or node.lineno, what,
                 held))


# -- graph build ---------------------------------------------------------------

def build_graph(repo: str) -> Graph:
    g = Graph(repo=repo)
    for rel in iter_python_files(repo):
        _index_module(g, rel)
    for mi in g.modules.values():
        _resolve_imports(g, mi)
    _resolve_bases(g)
    _collect_attr_types(g)
    for fi in g.funcs.values():
        _CallWalker(g, g.modules[fi.rel], fi).run()
    return g


def reachable(g: Graph, roots: Sequence[str]) -> Set[str]:
    seen: Set[str] = set()
    stack = [r for r in roots if r in g.funcs]
    while stack:
        q = stack.pop()
        if q in seen:
            continue
        seen.add(q)
        stack.extend(g.funcs[q].edges)
    return seen


# -- pass 1: hot-path property checks ------------------------------------------

def _site_matches(rule: str, node: ast.Call) -> Optional[str]:
    """When ``node`` violates ``rule``, a short description of what."""

    f = node.func
    if not isinstance(f, ast.Attribute):
        return None
    attr = f.attr
    base = f.value
    if rule == "hot-wallclock":
        if attr == "time" and isinstance(base, ast.Name) and \
                base.id == "time":
            return "time.time()"
    elif rule == "hot-json":
        if attr in ("loads", "dumps") and isinstance(base, ast.Name) \
                and base.id == "json":
            return f"json.{attr}()"
    elif rule == "hot-encode":
        if attr in ("encode", "splitlines"):
            return f".{attr}()"
    elif rule == "hot-fsync":
        if attr in ("fsync", "fdatasync", "flush"):
            return f".{attr}()"
    elif rule == "hot-blocking-socket":
        if attr in ("settimeout", "makefile", "sendall", "accept"):
            return f".{attr}()"
        if attr == "setblocking":
            # shared predicate with the lint twin — cannot drift
            if not setblocking_pinned_nonblocking(node):
                return ".setblocking() not pinned to False"
        if attr == "sleep" and isinstance(base, ast.Name) and \
                base.id == "time":
            return "time.sleep()"
    return None


_PROP_HINTS = {
    "hot-wallclock": ("NTP steps skew deadlines/intervals — use "
                      "time.monotonic(), or suppress where a "
                      "wall-clock timestamp is the API"),
    "hot-json": ("the sweep path is binary delta frames "
                 "(tpumon_torch/sweepframe.py) — use the wire codec, or "
                 "suppress naming this as a negotiation/oracle/"
                 "non-sweep-op site"),
    "hot-encode": ("the pipeline is bytes-oriented and incremental — "
                   "cache the encoded form, or suppress with a comment "
                   "explaining why this runs less than once per sweep"),
    "hot-fsync": ("flushing is time-based, never per sweep — route "
                  "through the timed-flush helper or suppress with a "
                  "comment explaining the cadence"),
    "hot-blocking-socket": ("one blocking call stalls every host's "
                            "sweep — sockets must be non-blocking with "
                            "deadlines from the loop's monotonic "
                            "clock"),
}


def _scan_nodes(prop: HotProperty, rel: str, nodes: Sequence[ast.AST],
                supp: Optional[Suppressions], why: str,
                def_lines: Tuple[int, ...],
                out: List[Finding], seen: Set[Tuple[str, str, int]],
                ) -> None:
    for root_node in nodes:
        stack: List[Tuple[ast.AST, Tuple[int, ...]]] = \
            [(root_node, def_lines)]
        while stack:
            node, dlines = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                dlines = dlines + _def_header_lines(node)
            elif isinstance(node, ast.Call):
                what = _site_matches(prop.rule, node)
                if what is not None:
                    key = (prop.rule, rel, node.lineno)
                    if key not in seen:
                        span = range(node.lineno,
                                     (node.end_lineno
                                      or node.lineno) + 1)
                        if supp is None or not supp.suppressed(
                                prop.rule, prop.lint_alias,
                                *span, *dlines):
                            seen.add(key)
                            out.append(Finding(
                                rel, node.lineno, prop.rule,
                                f"{what} {why}: "
                                f"{_PROP_HINTS[prop.rule]}"))
            for child in ast.iter_child_nodes(node):
                stack.append((child, dlines))


def check_hot_properties(g: Graph, manifest: Dict[str, List[str]],
                         ignore_suppressions: bool = False,
                         legacy_scope: bool = True,
                         ) -> List[Finding]:
    """``legacy_scope=False`` restricts the pass to pure reachability —
    the parity test uses it to measure what the call graph covers on
    its own, without the retained filename scopes."""
    out: List[Finding] = []
    # one BFS per root: the group closure is the union of its roots'
    # closures, and root_of records which root reaches each function
    # (for the finding message) — no second traversal
    closures: Dict[str, Set[str]] = {}
    root_of: Dict[str, Dict[str, str]] = {}
    for group, roots in manifest.items():
        closure: Set[str] = set()
        for r in roots:
            if r not in g.funcs:
                out.append(Finding(
                    r.split("::")[0], 0, "hot-root-missing",
                    f"hot root {r!r} (group {group!r}) does not "
                    f"resolve — update HOT_ROOTS or restore the "
                    f"function"))
            for q in reachable(g, [r]):
                root_of.setdefault(group, {}).setdefault(q, r)
                closure.add(q)
        closures[group] = closure
    for prop in PROPERTIES:
        seen: Set[Tuple[str, str, int]] = set()
        # reachability scope: every function in the closure of the
        # property's root groups
        for group in prop.groups:
            for q in sorted(closures.get(group, ())):
                fi = g.funcs[q]
                supp = None if ignore_suppressions else \
                    g.modules[fi.rel].supp
                via = root_of.get(group, {}).get(q, "?")
                why = f"in the hot path (reachable from {via})"
                body = list(fi.node.body)  # type: ignore[attr-defined]
                _scan_nodes(prop, fi.rel, body, supp, why,
                            fi.def_lines, out, seen)
        # legacy filename scope (parity cross-check with tpumon_lint)
        if not legacy_scope:
            continue
        for rel, mi in sorted(g.modules.items()):
            if not (rel.startswith(prop.legacy_prefixes)
                    if prop.legacy_prefixes else False) \
                    and rel not in prop.legacy_files:
                continue
            supp = None if ignore_suppressions else mi.supp
            _scan_nodes(prop, rel, list(mi.tree.body), supp,
                        "in a legacy-scoped hot-path file", (), out,
                        seen)
    return out


#: the pure-Python codec hot loops: reachable from a hot
#: root ONLY through the facade fallback branches, each of which
#: carries a reasoned ``# tpumon: codec-ok(...)`` pragma — any other
#: hot-path caller bypasses the native dispatch and must be flagged
_PY_CODEC_IMPLS = frozenset({
    "tpumon_torch/sweepframe.py::PySweepFrameEncoder.encode_frame",
    "tpumon_torch/sweepframe.py::PySweepFrameDecoder.apply",
    "tpumon_torch/burst.py::PyBurstAccumulator.fold",
    "tpumon_torch/burst.py::PyBurstAccumulator.fold_series",
})


def check_hot_python_codec(g: Graph, manifest: Dict[str, List[str]],
                           ignore_suppressions: bool = False,
                           ) -> List[Finding]:
    """``hot-python-codec``: a call site resolving to a pure-Python
    codec hot loop, in a function reachable from ANY hot root.  The
    facades are supposed to be the only such callers (their fallback
    branches are pragma-suppressed with reasons, counted in the
    baseline); a hot path calling ``PySweepFrameEncoder`` & co
    directly would silently forfeit the native core."""

    out: List[Finding] = []
    root_of: Dict[str, str] = {}
    for group, roots in manifest.items():
        for r in roots:
            for q in reachable(g, [r]):
                root_of.setdefault(q, r)
    seen: Set[Tuple[str, int]] = set()
    for q in sorted(root_of):
        fi = g.funcs[q]
        supp = None if ignore_suppressions else g.modules[fi.rel].supp
        for callee, lines in fi.edges.items():
            if callee not in _PY_CODEC_IMPLS:
                continue
            impl = callee.split("::")[1]
            for line in lines:
                key = (fi.rel, line)
                if key in seen:
                    continue
                if supp is not None and supp.suppressed(
                        "hot-python-codec", None, line, *fi.def_lines):
                    continue
                seen.add(key)
                out.append(Finding(
                    fi.rel, line, "hot-python-codec",
                    f"{impl}() called on the hot path (reachable from "
                    f"{root_of[q]}): dispatch through the facade so "
                    f"the native codec core serves when built, or "
                    f"suppress with '# tpumon: codec-ok(reason)'"))
    return out


# -- pass 2: lock analysis -----------------------------------------------------

def _entry_held_fixpoint(g: Graph) -> Dict[str, Set[str]]:
    """Locks possibly held at entry of each function (fixpoint over
    the call graph) — shared by the lock pass and the thread pass."""

    entry: Dict[str, Set[str]] = {q: set() for q in g.funcs}
    changed = True
    rounds = 0
    while changed and rounds < 50:
        changed = False
        rounds += 1
        for q, fi in g.funcs.items():
            base = entry[q]
            for callee, held in fi.calls_held + fi.def_edges_held:
                if callee not in entry:
                    continue
                want = base | set(held)
                if not want <= entry[callee]:
                    entry[callee] |= want
                    changed = True
    return entry


def _entry_must_hold(g: Graph) -> Dict[str, Set[str]]:
    """Locks held on EVERY known path into each function (intersection
    over call sites, fixpoint from top).  The guarded-by join uses
    this MUST analysis: claiming an attribute is guarded requires the
    lock on every path, where the blocking pass's MAY analysis unions
    over callers and would invent guards that only sometimes hold.
    Functions with no repo-internal caller enter with nothing held."""

    callers: Dict[str, List[Tuple[str, Tuple[str, ...]]]] = {}
    for q, fi in g.funcs.items():
        for callee, held in fi.calls_held:
            if callee in g.funcs:
                callers.setdefault(callee, []).append((q, held))
    # None = top (not yet constrained); values only ever shrink
    entry: Dict[str, Optional[Set[str]]] = {
        q: (None if q in callers else set()) for q in g.funcs}
    changed = True
    rounds = 0
    while changed and rounds < 100:
        changed = False
        rounds += 1
        for q in g.funcs:
            cs = callers.get(q)
            if not cs:
                continue
            acc: Optional[Set[str]] = None
            for cq, held in cs:
                ce = entry.get(cq)
                if ce is None:
                    continue  # caller still top: no constraint yet
                site = ce | set(held)
                acc = set(site) if acc is None else (acc & site)
            if acc is None:
                continue
            cur = entry[q]
            new = acc if cur is None else (cur & acc)
            if cur is None or new != cur:
                entry[q] = new
                changed = True
    return {q: (v if v is not None else set())
            for q, v in entry.items()}


def check_locks(g: Graph, ignore_suppressions: bool = False,
                ) -> List[Finding]:
    out: List[Finding] = []
    entry = _entry_held_fixpoint(g)
    # (a) acquisition-order pairs -> cycle detection
    edges: Dict[str, Set[str]] = {}
    sites: Dict[Tuple[str, str], Tuple[str, int]] = {}
    lock_kinds = _lock_kind_table(g)
    self_rec: List[Finding] = []
    for q, fi in sorted(g.funcs.items()):
        supp = None if ignore_suppressions else g.modules[fi.rel].supp
        for lock, line, held_lex in fi.acquires:
            held = entry[q] | set(held_lex)
            for h in held:
                if h == lock:
                    # re-acquiring a lock already held: fine for an
                    # RLock, a guaranteed self-deadlock for a plain
                    # Lock.  Only registry-known plain Locks are
                    # flagged — heuristic ids have unknown kinds.
                    if lock_kinds.get(lock) == "Lock" and (
                            supp is None or not supp.suppressed(
                                "lock-self-recursion", None, line,
                                *fi.def_lines)):
                        self_rec.append(Finding(
                            fi.rel, line, "lock-self-recursion",
                            f"{_short_lock(lock)} is a plain "
                            f"threading.Lock and some caller already "
                            f"holds it when this function acquires it "
                            f"— a guaranteed self-deadlock (make it "
                            f"an RLock, or split the locked helper "
                            f"out)"))
                    continue
                edges.setdefault(h, set()).add(lock)
                sites.setdefault((h, lock), (fi.rel, line))
    out.extend(self_rec)
    for cycle in _find_cycles(edges):
        pair_desc = []
        for i, a in enumerate(cycle):
            b = cycle[(i + 1) % len(cycle)]
            rel, line = sites.get((a, b), ("?", 0))
            pair_desc.append(f"{_short_lock(a)} -> {_short_lock(b)} "
                             f"(at {rel}:{line})")
        rel0, line0 = sites.get((cycle[0], cycle[1 % len(cycle)]),
                                ("?", 0))
        out.append(Finding(
            rel0, line0, "lock-order-cycle",
            "lock acquisition order cycle: " + "; ".join(pair_desc)
            + " — pick one global order and stick to it"))
    # (b) blocking call while a lock is held
    for q, fi in sorted(g.funcs.items()):
        supp = None if ignore_suppressions else g.modules[fi.rel].supp
        for line, end_line, what, held_lex in fi.blocking:
            held = entry[q] | set(held_lex)
            if not held:
                continue
            span = range(line, end_line + 1)
            if supp is not None and supp.suppressed(
                    "blocking-while-locked", None, *span,
                    *fi.def_lines):
                continue
            locks = ", ".join(sorted(_short_lock(h) for h in held))
            out.append(Finding(
                fi.rel, line, "blocking-while-locked",
                f"{what} while holding {locks}: every other thread "
                f"contending for the lock stalls behind this call — "
                f"move it outside the critical section, or suppress "
                f"with a comment explaining why the wait is bounded "
                f"and intended"))
    return out


def _lock_kind_table(g: Graph) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for ci in g.classes.values():
        for attr, kind in ci.lock_attrs.items():
            out[f"{ci.qname}.{attr}"] = kind
    for mi in g.modules.values():
        for name, kind in mi.lock_globals.items():
            out[f"{mi.rel}::{name}"] = kind
    return out


def _short_lock(lock_id: str) -> str:
    # "tpumon_torch/blackbox.py::BlackBoxWriter._lock" -> BlackBoxWriter._lock
    return lock_id.rsplit("::", 1)[-1]


def _find_cycles(edges: Dict[str, Set[str]]) -> List[List[str]]:
    """One representative cycle per non-trivial SCC (Tarjan).  Every
    consecutive pair in a returned path — including the closing
    last->first edge — is a real edge, so the report only ever cites
    acquisition orders that actually occur.  Self-edges are filtered
    by the caller (they are the lock-self-recursion rule's job)."""

    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    counter = [0]
    sccs: List[List[str]] = []

    def strongconnect(v: str) -> None:
        work = [(v, iter(sorted(edges.get(v, ()))))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(edges.get(w, ())))))
                    advanced = True
                    break
                if w in on_stack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                if len(comp) > 1:
                    sccs.append(sorted(comp))

    for v in sorted(edges):
        if v not in index:
            strongconnect(v)
    cycles: List[List[str]] = []
    for comp in sccs:
        # walk intra-SCC edges from one node until a node repeats: the
        # repeated suffix is a genuine cycle (an SCC node always has
        # an intra-SCC successor, so the walk cannot dead-end)
        compset = set(comp)
        path = [comp[0]]
        index_of = {comp[0]: 0}
        while True:
            nxt = next(w for w in sorted(edges.get(path[-1], ()))
                       if w in compset)
            if nxt in index_of:
                cycles.append(path[index_of[nxt]:])
                break
            index_of[nxt] = len(path)
            path.append(nxt)
    return cycles


# -- pass 3: thread provenance + guarded-by ------------------------------------

@dataclass(frozen=True)
class _AttrSite:
    """One ``self.attr`` access with its thread/lock provenance."""

    rel: str
    line: int
    func: str                       # owning function qname
    roles: FrozenSet[str]           # non-main roles at this site
    held: FrozenSet[str]            # locks possibly held at this site
    kind: str                       # "read" | "assign" | "mutate"


@dataclass
class ThreadModel:
    """Everything the race rules consume: per-function role sets and
    per-(class, attribute) access sites with held-lock provenance."""

    roles: Dict[str, Set[str]]
    attrs: Dict[Tuple[str, str], List[_AttrSite]]
    affine: Dict[Tuple[str, str], str]
    findings: List[Finding]


def compute_thread_roles(g: Graph, manifest: Dict[str, List[str]],
                         ) -> Tuple[Dict[str, Set[str]], List[Finding]]:
    """Thread roles per function: seed the declared roots (pinned) and
    every module-level ``main`` (the caller-context ``main`` role),
    then propagate through call edges to a fixpoint.  A pinned root
    never inherits callers' roles — that is how a function posted
    cross-thread (``run_on_loop``) keeps its executing thread's role
    rather than its definer's."""

    findings: List[Finding] = []
    roles: Dict[str, Set[str]] = {q: set() for q in g.funcs}
    pinned: Set[str] = set()
    for group, roots in manifest.items():
        for r in roots:
            if r not in g.funcs:
                findings.append(Finding(
                    r.split("::")[0], 0, "thread-root-missing",
                    f"thread root {r!r} (role {group!r}) does not "
                    f"resolve — update THREAD_ROOTS or restore the "
                    f"function"))
                continue
            roles[r].add(group)
            pinned.add(r)
    for q, fi in g.funcs.items():
        if fi.cls is None and q.split("::", 1)[1] == "main":
            roles[q].add(MAIN_ROLE)
            pinned.add(q)
    changed = True
    rounds = 0
    while changed and rounds < 100:
        changed = False
        rounds += 1
        for q, fi in g.funcs.items():
            rq = roles[q]
            if not rq:
                continue
            for callee in fi.edges:
                if callee in pinned or callee not in roles:
                    continue
                if not rq <= roles[callee]:
                    roles[callee] |= rq
                    changed = True
    return roles, findings


def _class_chain(g: Graph, cls_q: Optional[str]) -> Iterator[ClassInfo]:
    seen: Set[str] = set()
    while cls_q is not None and cls_q not in seen:
        seen.add(cls_q)
        ci = g.classes.get(cls_q)
        if ci is None:
            return
        yield ci
        cls_q = ci.bases[0] if ci.bases else None


def _skip_attr(g: Graph, cls_q: Optional[str], attr: str) -> bool:
    """Attrs excluded from the conflict rules: locks and other sync
    primitives (thread-safe by design) and methods (code, not data)."""

    for ci in _class_chain(g, cls_q):
        if attr in ci.lock_attrs or attr in ci.sync_attrs:
            return True
        if attr in ci.methods:
            return True
    return False


def _attr_owner(g: Graph, cls_q: str, attr: str) -> str:
    """The topmost base class that declares ``attr`` (so accesses in a
    subclass and its base join one analysis key)."""

    owner = cls_q
    for ci in _class_chain(g, cls_q):
        if attr in ci.attr_types or attr in ci.lock_attrs or \
                attr in ci.sync_attrs or attr in ci.affine_attrs:
            owner = ci.qname
    return owner


def build_thread_model(g: Graph,
                       manifest: Dict[str, List[str]]) -> ThreadModel:
    roles, findings = compute_thread_roles(g, manifest)
    entry = _entry_must_hold(g)
    attrs: Dict[Tuple[str, str], List[_AttrSite]] = {}
    affine: Dict[Tuple[str, str], str] = {}
    for ci in g.classes.values():
        for attr, kind in ci.affine_attrs.items():
            affine[(_attr_owner(g, ci.qname, attr), attr)] = kind
    for q, fi in sorted(g.funcs.items()):
        if fi.cls is None:
            continue
        if fi.name == "__init__":
            # constructor confinement: the object under construction
            # is not yet visible to any other thread, so __init__
            # sites cannot race (nested defs under __init__ — e.g.
            # the http dispatch closures — are NOT exempt)
            continue
        if any(ci.name in _AFFINE_CLASS_NAMES
               for ci in _class_chain(g, fi.cls)):
            # an affine class's own state is single-thread by its
            # instance contract; the thread-affinity rule checks the
            # HOLDERS of its instances instead
            continue
        nonmain = frozenset(roles.get(q, set()) - {MAIN_ROLE})
        ent = entry.get(q, set())
        for attr, line, held_lex in fi.attr_reads:
            if _skip_attr(g, fi.cls, attr):
                continue
            key = (_attr_owner(g, fi.cls, attr), attr)
            attrs.setdefault(key, []).append(_AttrSite(
                fi.rel, line, q, nonmain,
                frozenset(ent | set(held_lex)), "read"))
        for attr, line, held_lex, kind in fi.attr_writes:
            if _skip_attr(g, fi.cls, attr):
                continue
            key = (_attr_owner(g, fi.cls, attr), attr)
            attrs.setdefault(key, []).append(_AttrSite(
                fi.rel, line, q, nonmain,
                frozenset(ent | set(held_lex)), kind))
    return ThreadModel(roles=roles, attrs=attrs, affine=affine,
                       findings=findings)


def _roles_conflict(a: _AttrSite, b: _AttrSite) -> bool:
    """True when the two sites can run on two DIFFERENT named threads:
    some role of ``a`` differs from some role of ``b`` (a single site
    whose role set holds two roles conflicts with itself — two
    instances of the same loop on two threads)."""

    return bool(a.roles) and bool(b.roles) and len(a.roles | b.roles) > 1


def _fmt_roles(s: _AttrSite) -> str:
    return "/".join(sorted(s.roles)) or "?"


def _attr_label(key: Tuple[str, str]) -> str:
    cls_q, attr = key
    return f"{cls_q.rsplit('::', 1)[-1]}.{attr}"


def check_threads(g: Graph,
                  manifest: Optional[Dict[str, List[str]]] = None,
                  ignore_suppressions: bool = False,
                  model: Optional[ThreadModel] = None) -> List[Finding]:
    manifest = THREAD_ROOTS if manifest is None else manifest
    if model is None:
        model = build_thread_model(g, manifest)
    out = list(model.findings)
    declared = {r for roots in manifest.values() for r in roots}

    def unsuppressed(rule: str, s: _AttrSite) -> bool:
        if ignore_suppressions:
            return True
        supp = g.modules[s.rel].supp
        dlines = g.funcs[s.func].def_lines if s.func in g.funcs else ()
        # a pragma on the line directly above the site (or above the
        # ``def`` header, covering the whole function) counts too —
        # thread-ok reasons are sentences and rarely fit at line end
        lines = (s.line, s.line - 1) + tuple(dlines)
        if dlines:
            lines += (min(dlines) - 1,)
        return not supp.suppressed(rule, None, *lines)

    # thread-root harvest: every Thread(target=<repo fn>) must be
    # declared, or the role analysis silently misses a whole thread
    for q, fi in sorted(g.funcs.items()):
        supp = None if ignore_suppressions else g.modules[fi.rel].supp
        for line, targets in fi.thread_spawns:
            if set(targets) & declared:
                continue
            if supp is not None and supp.suppressed(
                    "thread-root-undeclared", None, line, line - 1,
                    *fi.def_lines):
                continue
            out.append(Finding(
                fi.rel, line, "thread-root-undeclared",
                f"thread target {', '.join(targets)} is not declared "
                f"in THREAD_ROOTS — register it under a role so the "
                f"race pass knows this thread exists "
                f"(tpumon_torch/docs/static_analysis.md)"))

    for key in sorted(model.attrs):
        sites = model.attrs[key]
        writes = [s for s in sites if s.kind != "read"]
        reads = [s for s in sites if s.kind == "read"]
        mutates = [s for s in writes if s.kind == "mutate"]
        label = _attr_label(key)

        # (a) unguarded cross-thread write: two writers on different
        # roles with no common lock
        done = False
        for i, w1 in enumerate(writes):
            if done:
                break
            for w2 in writes[i:]:
                if not _roles_conflict(w1, w2) or (w1.held & w2.held):
                    continue
                if not (unsuppressed("thread-unguarded-write", w1)
                        and unsuppressed("thread-unguarded-write", w2)):
                    continue
                guard = set(writes[0].held)
                for w in writes[1:]:
                    guard &= w.held
                inferred = ", ".join(sorted(
                    _short_lock(x) for x in guard)) or "none"
                out.append(Finding(
                    w2.rel, w2.line, "thread-unguarded-write",
                    f"{label} is written from thread role(s) "
                    f"{_fmt_roles(w1)} (at {w1.rel}:{w1.line}) and "
                    f"{_fmt_roles(w2)} with no common lock (inferred "
                    f"guarded-by across all writes: {inferred}) — "
                    f"guard every writer with one lock, or suppress "
                    f"with '# tpumon: thread-ok(reason)' stating the "
                    f"ownership contract"))
                done = True
                break

        # (b) torn read: in-place mutation on one role, read on
        # another, no common lock — once per read site
        for s in reads:
            for w in mutates:
                if (w.rel, w.line) == (s.rel, s.line):
                    continue
                if not _roles_conflict(s, w) or (s.held & w.held):
                    continue
                if not (unsuppressed("thread-torn-read", s)
                        and unsuppressed("thread-torn-read", w)):
                    continue
                out.append(Finding(
                    s.rel, s.line, "thread-torn-read",
                    f"{label} is mutated in place from role(s) "
                    f"{_fmt_roles(w)} (at {w.rel}:{w.line}) and read "
                    f"here from role(s) {_fmt_roles(s)} with no "
                    f"common lock — the reader can observe a "
                    f"half-applied update; take the writer's lock "
                    f"(copy under it), or suppress with "
                    f"'# tpumon: thread-ok(reason)'"))
                break

    # (c) thread-affine objects touched from two roles (locks do not
    # help: selectors/sockets/codec tables have an owning thread)
    for key in sorted(model.affine):
        kind = model.affine[key]
        sites = sorted(model.attrs.get(key, []),
                       key=lambda s: (s.rel, s.line))
        label = _attr_label(key)
        done = False
        for i, s1 in enumerate(sites):
            if done:
                break
            for s2 in sites[i:]:
                if not _roles_conflict(s1, s2):
                    continue
                if not (unsuppressed("thread-affinity", s1)
                        and unsuppressed("thread-affinity", s2)):
                    continue
                out.append(Finding(
                    s2.rel, s2.line, "thread-affinity",
                    f"{label} is a thread-affine {kind} touched from "
                    f"role(s) {_fmt_roles(s1)} (at {s1.rel}:{s1.line}) "
                    f"and {_fmt_roles(s2)} — affine objects have one "
                    f"owning thread; route the access through the "
                    f"owner (e.g. FrameServer.run_on_loop), or "
                    f"suppress with '# tpumon: thread-ok(reason)'"))
                done = True
                break
    return out


def thread_guard_table(g: Graph,
                       manifest: Optional[Dict[str, List[str]]] = None,
                       model: Optional[ThreadModel] = None,
                       ) -> Dict[str, Dict[str, List[str]]]:
    """The inferred guarded-by table: for every attribute written from
    at least one named (non-main) thread role, the roles that touch it
    and the locks held at EVERY write site (the inferred guard).  The
    ``--thread-report`` / ``--json`` surface of the race pass."""

    if model is None:
        model = build_thread_model(g, THREAD_ROOTS if manifest is None
                                   else manifest)
    table: Dict[str, Dict[str, List[str]]] = {}
    for key in sorted(model.attrs):
        sites = model.attrs[key]
        writes = [s for s in sites if s.kind != "read"]
        if not writes:
            continue
        roles: Set[str] = set()
        for s in sites:
            roles |= s.roles
        if not roles:
            continue
        guard = set(writes[0].held)
        for w in writes[1:]:
            guard &= w.held
        table[_attr_label(key)] = {
            "roles": sorted(roles),
            "guarded_by": sorted(_short_lock(x) for x in guard),
        }
    return table


# -- pass 4: wire-protocol constant sync ---------------------------------------

def _py_int_constants(tree: ast.Module, suffix: str) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                node.targets[0].id.endswith(suffix) and \
                isinstance(node.value, ast.Constant) and \
                isinstance(node.value.value, int):
            out[node.targets[0].id] = node.value.value
    return out


def _py_sent_ops(tree: ast.Module) -> Set[str]:
    """Every op name this module sends: ``{\"op\": \"x\"}`` dict
    literals plus ``self._call(\"x\", ...)`` first arguments."""

    ops: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if isinstance(k, ast.Constant) and k.value == "op" and \
                        isinstance(v, ast.Constant) and \
                        isinstance(v.value, str):
                    ops.add(v.value)
        elif isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr == "_call" and \
                    node.args and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                ops.add(node.args[0].value)
    return ops


def _py_handled_ops(tree: ast.Module) -> Set[str]:
    """Op names a server-side module dispatches on: ``op == \"x\"``."""

    ops: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Compare) and \
                isinstance(node.left, ast.Name) and \
                node.left.id == "op" and len(node.comparators) == 1 and \
                isinstance(node.comparators[0], ast.Constant) and \
                isinstance(node.comparators[0].value, str):
            ops.add(node.comparators[0].value)
    return ops


def _append_value_fields(tree: ast.Module) -> Tuple[Set[int], Set[int]]:
    """Field numbers `_append_value` writes into a value entry and its
    vector submessage (the Python reference encoder)."""

    entry: Set[int] = set()
    vec: Set[int] = set()
    fn = None
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and \
                node.name == "_append_value":
            fn = node
            break
    if fn is None:
        return entry, vec
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Name) and \
                node.func.id.startswith("write_") and \
                len(node.args) >= 2 and \
                isinstance(node.args[0], ast.Name) and \
                isinstance(node.args[1], ast.Constant) and \
                isinstance(node.args[1].value, int):
            if node.args[0].id == "sub":
                entry.add(node.args[1].value)
            elif node.args[0].id == "vec":
                vec.add(node.args[1].value)
    return entry, vec


def _encode_frame_inline_fields(tree: ast.Module) -> Set[int]:
    """Field numbers the inlined ``encode_frame`` hot loop emits via
    raw tag bytes / constants — must stay within the reference set."""

    fields: Set[int] = set()
    fn = None
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and \
                node.name == "encode_frame":
            fn = node
            break
    if fn is None:
        return fields
    for node in ast.walk(fn):
        # scratch += b"\x20\x01" style raw tag bytes
        if isinstance(node, ast.Constant) and \
                isinstance(node.value, bytes) and node.value:
            fields.add(node.value[0] >> 3)
        # scratch.append(0x31) style single tag bytes
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "append" and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, int):
            fields.add(node.args[0].value >> 3)
    return fields


def _event_fields_py(tree: ast.Module) -> Set[int]:
    """Field numbers written into the piggybacked-event submessage
    (``ev``) by ``encode_frame``."""

    out: Set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Name) and \
                node.func.id.startswith("write_") and \
                len(node.args) >= 2 and \
                isinstance(node.args[0], ast.Name) and \
                node.args[0].id == "ev" and \
                isinstance(node.args[1], ast.Constant) and \
                isinstance(node.args[1].value, int):
            out.add(node.args[1].value)
    return out


_CC_MAGIC_RE = re.compile(
    r"k(\w+Magic)\s*=\s*0x([0-9A-Fa-f]+)")
# op dispatch is extracted by cc_op_handler_table (pass 7): the op
# literals come from the token stream and each one is resolved to the
# handler function its guarded statement calls — not a regex scan
_CC_ENTRY_RE = re.compile(
    r"put_(?:varint|len|double)_field\(&entry,\s*(\d+)")
_CC_ENTRY_NUM_RE = re.compile(
    r"append_sweep_number\(&entry,\s*(\d+),\s*(\d+)")
_CC_VEC_RE = re.compile(
    r"put_(?:varint|len|double)_field\(&vecb,\s*(\d+)")
_CC_VEC_NUM_RE = re.compile(
    r"append_sweep_number\(&vecb,\s*(\d+),\s*(\d+)")
_CC_EV_RE = re.compile(
    r"put_(?:varint|len|double)_field\(\s*&ev,\s*(\d+)")
_CC_BURST_BASE_RE = re.compile(r"kBurstIdBase\s*=\s*(\d+)")
_CC_NAMED_FIELD_RE = re.compile(r"k(Value|Frame)Field(\w+)\s*=\s*(\d+)")
#: the reference wire layout (tpumon_torch/native/agent/protocol.md): frame payload
#: fields and value-entry fields the native core's named constants
#: must match — the Python reference writes these as literals, so the
#: names only exist on the C++ side
_CODEC_FIELD_LAYOUT: Dict[Tuple[str, str], int] = {
    ("Frame", "Index"): 1, ("Frame", "Chip"): 2,
    ("Frame", "Removed"): 3, ("Frame", "Event"): 4,
    ("Value", "Id"): 1, ("Value", "Int"): 2, ("Value", "Vec"): 3,
    ("Value", "Blank"): 4, ("Value", "Str"): 5, ("Value", "Double"): 6,
}
#: the varint length caps of the two protobuf walkers
_PY_VARINT_CAP_RE = re.compile(r"\bpos\s*-\s*start\s*>=\s*(\d+)")
_CC_VARINT_CAP_RE = re.compile(r"\bpos_\s*-\s*start\s*>=\s*(\d+)")
_CC_BURST_FIELDS_RE = re.compile(
    r"kBurstSourceFields\[\]\s*=\s*\{([0-9,\s]*)\}")
_MD_OP_ROW_RE = re.compile(r"^\|\s*`(\w+)`\s*\|", re.MULTILINE)
_MD_TAG_ROW_RE = re.compile(r"^\|\s*`0x([0-9A-Fa-f]{2})`\s*\|",
                            re.MULTILINE)
_HEX_MENTION_RE = re.compile(r"`0x([0-9A-Fa-f]{2})`")
_INT_LIMIT_RE = re.compile(r"9\.?0?e\s*15|9e15")


def built_codec_constants(repo: str) -> Optional[Dict[str, float]]:
    """The exported integer/float constants of the ``_tpumon_torch_codec``
    build of the current sources, or None when this checkout has none
    built (the extension is optional: the facades fall back to Python).
    Only the checkout this tool lives in is asked: a mini-tree has no
    build of its own.  Loading it compiles nothing."""

    if os.path.realpath(repo) != os.path.realpath(_REPO_ROOT):
        return None
    try:
        from tpumon_torch import _build
        mod = _build.load_extension(CODEC_EXTENSION)
    except ImportError:
        return None
    if mod is None:
        return None
    return {k: v for k, v in vars(mod).items()
            if k.isupper() and isinstance(v, (int, float))}


def check_protocol_sync(repo: str, *,
                        codec_constants: Optional[Dict[str, float]] = None,
                        ) -> List[Finding]:
    """Pass 4.  ``codec_constants`` are the built codec extension's
    exported constants (default: :func:`built_codec_constants`)."""

    out: List[Finding] = []

    def read(rel: str) -> Optional[str]:
        path = os.path.join(repo, rel)
        if not os.path.isfile(path):
            out.append(Finding(rel, 0, "wire-constant-sync",
                               "file missing — the protocol "
                               "cross-check cannot run"))
            return None
        with open(path, encoding="utf-8") as f:
            return f.read()

    def parse_py(rel: str) -> Optional[ast.Module]:
        src = read(rel)
        if src is None:
            return None
        try:
            return ast.parse(src)
        except SyntaxError:
            return None  # parse-error reported by the graph pass

    sf_tree = parse_py("tpumon_torch/sweepframe.py")
    bb_tree = parse_py("tpumon_torch/blackbox.py")
    agent_tree = parse_py("tpumon_torch/backends/agent.py")
    fleet_tree = parse_py("tpumon_torch/fleetpoll.py")
    sim_tree = parse_py("tpumon_torch/agentsim.py")
    shard_tree = parse_py("tpumon_torch/fleetshard.py")
    main_cc = read("tpumon_torch/native/agent/main.cc")
    proto_md = read("tpumon_torch/native/agent/protocol.md")
    bb_md = read(BLACKBOX_DOC)
    if None in (sf_tree, bb_tree, main_cc, proto_md, bb_md):
        return out

    assert sf_tree and bb_tree and main_cc and proto_md and bb_md
    py_magics = _py_int_constants(sf_tree, "_MAGIC")
    bb_magics = _py_int_constants(bb_tree, "_MAGIC")
    cc_magics = {m.group(1): int(m.group(2), 16)
                 for m in _CC_MAGIC_RE.finditer(main_cc)}

    # frame magics: Python twin == C++ daemon == protocol.md
    for py_name, cc_name in (("SWEEP_REQ_MAGIC", "SweepReqMagic"),
                             ("SWEEP_FRAME_MAGIC", "SweepFrameMagic")):
        pv = py_magics.get(py_name)
        cv = cc_magics.get(cc_name)
        if pv is None or cv is None:
            out.append(Finding(
                "tpumon_torch/sweepframe.py", 0, "wire-constant-sync",
                f"{py_name}/k{cc_name} not found in "
                f"sweepframe.py/main.cc — the magic cross-check "
                f"cannot run"))
        elif pv != cv:
            out.append(Finding(
                "tpumon_torch/sweepframe.py", 0, "wire-constant-sync",
                f"{py_name} is {pv:#x} but tpumon_torch/native/agent/main.cc "
                f"k{cc_name} is {cv:#x} — the framing handshake is "
                f"broken"))
        if pv is not None:
            mentioned = {int(h, 16)
                         for h in _HEX_MENTION_RE.findall(proto_md)}
            if pv not in mentioned:
                out.append(Finding(
                    "tpumon_torch/native/agent/protocol.md", 0, "wire-constant-sync",
                    f"{py_name} {pv:#x} is not documented in the "
                    f"framing section"))

    # blackbox record tags: constants == docs table, and disjoint from
    # the wire magics + '{' (the frame-switch byte)
    doc_tags = {int(h, 16) for h in _MD_TAG_ROW_RE.findall(bb_md)}
    py_tags = set(bb_magics.values())
    frame_magic = py_magics.get("SWEEP_FRAME_MAGIC")
    if frame_magic is not None:
        expect_doc = py_tags | {frame_magic}
        if doc_tags != expect_doc:
            out.append(Finding(
                BLACKBOX_DOC, 0, "wire-constant-sync",
                f"record-tag table lists "
                f"{sorted(hex(t) for t in doc_tags)} but the code "
                f"defines {sorted(hex(t) for t in expect_doc)} — "
                f"update the format table"))
    clash = py_tags & ({py_magics.get("SWEEP_REQ_MAGIC"), ord('{')}
                       - {None})
    if clash:
        out.append(Finding(
            "tpumon_torch/blackbox.py", 0, "wire-constant-sync",
            f"record tag(s) {sorted(hex(c) for c in clash)} collide "
            f"with the wire request magic or '{{' — segment records "
            f"must stay frame-switchable"))

    # op names: every op the Python clients send must exist in the C++
    # dispatch; the C++ dispatch must match the protocol.md table; the
    # fleet poller must stay within what agentsim serves.  The C++ side
    # comes from the pass-7 op-handler table (token stream + declared
    # functions), so each dispatched op is also pinned to the handler
    # its guarded statement calls
    native_idx = build_native_index(repo)
    op_table = cc_op_handler_table(
        cc_lex(main_cc), frozenset(native_idx.by_name))
    cc_ops = set(op_table)
    # a dispatch where NO op resolves is a stub (tests, inline-only
    # servers); once any op routes through a declared handler, every
    # op must — an unresolvable one is a dispatch the table lost
    if any(h is not None for h, _ in op_table.values()):
        for op in sorted(cc_ops):
            handler, op_line = op_table[op]
            if handler is None:
                out.append(Finding(
                    "tpumon_torch/native/agent/main.cc", op_line,
                    "wire-constant-sync",
                    f"op {op!r} is dispatched but its guarded "
                    f"statement calls no declared function — the "
                    f"op-handler table cannot resolve where this op "
                    f"lands"))
    md_ops = set(_MD_OP_ROW_RE.findall(proto_md)) - {"op"}
    sent: Set[str] = set()
    if agent_tree:
        sent |= _py_sent_ops(agent_tree)
    if fleet_tree:
        sent |= _py_sent_ops(fleet_tree)
    for op in sorted(sent - cc_ops):
        out.append(Finding(
            "tpumon_torch/backends/agent.py", 0, "wire-constant-sync",
            f"client sends op {op!r} but tpumon_torch/native/agent/main.cc has no "
            f"dispatch for it"))
    for op in sorted(cc_ops - md_ops):
        out.append(Finding(
            "tpumon_torch/native/agent/protocol.md", 0, "wire-constant-sync",
            f"daemon dispatches op {op!r} but the protocol table does "
            f"not document it"))
    for op in sorted(md_ops - cc_ops):
        out.append(Finding(
            "tpumon_torch/native/agent/protocol.md", 0, "wire-constant-sync",
            f"protocol table documents op {op!r} but "
            f"tpumon_torch/native/agent/main.cc does not dispatch it"))
    if fleet_tree is not None and sim_tree is not None:
        fleet_ops = _py_sent_ops(fleet_tree)
        sim_ops = _py_handled_ops(sim_tree)
        for op in sorted(fleet_ops - sim_ops):
            out.append(Finding(
                "tpumon_torch/agentsim.py", 0, "wire-constant-sync",
                f"the fleet poller sends op {op!r} but the simulated "
                f"agent farm does not serve it — the bench/failure "
                f"matrix would diverge from production"))
    if fleet_tree is not None and shard_tree is not None:
        # zero-new-protocol pin for the hierarchical fleet: a shard is
        # only agent-compatible if it dispatches every op the poller
        # can send — the top level speaks nothing a real agent would
        # not also answer
        fleet_ops = _py_sent_ops(fleet_tree)
        shard_ops = _py_handled_ops(shard_tree)
        for op in sorted(fleet_ops - shard_ops):
            out.append(Finding(
                "tpumon_torch/fleetshard.py", 0, "wire-constant-sync",
                f"the fleet poller sends op {op!r} but the shard "
                f"serve surface does not dispatch it — a shard must "
                f"stay consumable by the unmodified top-level poller"))
        sent_by_shard = _py_sent_ops(shard_tree)
        if sent_by_shard:
            out.append(Finding(
                "tpumon_torch/fleetshard.py", 0, "wire-constant-sync",
                f"fleetshard.py originates op literals "
                f"{sorted(sent_by_shard)} — the shard's client half "
                f"is fleetpoll.py; new ops belong in the protocol "
                f"table first"))

    # value-entry / vector / event field numbers: Python reference ==
    # C++ encoder; the inlined Python hot loop stays within the
    # reference set
    entry_py, vec_py = _append_value_fields(sf_tree)
    ev_py = _event_fields_py(sf_tree)
    entry_cc = {int(m.group(1)) for m in _CC_ENTRY_RE.finditer(main_cc)}
    for m in _CC_ENTRY_NUM_RE.finditer(main_cc):
        entry_cc.add(int(m.group(1)))
        entry_cc.add(int(m.group(2)))
    vec_cc = {int(m.group(1)) for m in _CC_VEC_RE.finditer(main_cc)}
    for m in _CC_VEC_NUM_RE.finditer(main_cc):
        vec_cc.add(int(m.group(1)))
        vec_cc.add(int(m.group(2)))
    ev_cc = {int(m.group(1)) for m in _CC_EV_RE.finditer(main_cc)}
    # the Python encoder is the executable spec: it also covers value
    # kinds the numeric-only C++ daemon never produces (strings), so
    # the C++ field sets must be SUBSETS of the Python reference —
    # anything the C++ encoder emits that the spec doesn't know is
    # drift the production decoder would reject
    if entry_py and entry_cc and not entry_cc <= entry_py:
        out.append(Finding(
            "tpumon_torch/sweepframe.py", 0, "wire-constant-sync",
            f"C++ sweep_frame emits value-entry field(s) "
            f"{sorted(entry_cc - entry_py)} the Python _append_value "
            f"reference never writes"))
    if vec_py and vec_cc and not vec_cc <= vec_py:
        out.append(Finding(
            "tpumon_torch/sweepframe.py", 0, "wire-constant-sync",
            f"C++ sweep_frame emits vector-element field(s) "
            f"{sorted(vec_cc - vec_py)} the Python reference never "
            f"writes"))
    if ev_py and ev_cc and ev_py != ev_cc:
        out.append(Finding(
            "tpumon_torch/sweepframe.py", 0, "wire-constant-sync",
            f"event field numbers differ: Python {sorted(ev_py)}, "
            f"C++ {sorted(ev_cc)}"))
    inline = _encode_frame_inline_fields(sf_tree)
    if inline and entry_py and not inline <= (entry_py | {1}):
        out.append(Finding(
            "tpumon_torch/sweepframe.py", 0, "wire-constant-sync",
            f"encode_frame's inlined hot loop emits field(s) "
            f"{sorted(inline - entry_py)} that the _append_value "
            f"reference never writes — the inline twin drifted"))

    # burst derived-field range: the generated C++ constants
    # (catalog.inc kBurstIdBase / kBurstSourceFields) must stay within
    # the Python declaration (fields.py BURST_ID_BASE /
    # BURST_SOURCE_FIELDS) — C++ ⊆ Python, the same direction as the
    # value-entry field pin above (the Python side is the executable
    # spec; a C++ source field the spec never declared would emit
    # derived ids the catalog cannot name).  Both sides are optional
    # (a tree without a burst engine has neither); declaring only one
    # side IS drift.
    def read_opt(rel: str) -> Optional[str]:
        path = os.path.join(repo, rel)
        if not os.path.isfile(path):
            return None
        with open(path, encoding="utf-8") as f:
            return f.read()

    fields_src = read_opt("tpumon_torch/fields.py")
    inc_text = read_opt("tpumon_torch/native/agent/catalog.inc")
    py_burst_base: Optional[int] = None
    py_burst_srcs: Optional[Set[int]] = None
    if fields_src is not None:
        try:
            ftree: Optional[ast.Module] = ast.parse(fields_src)
        except SyntaxError:
            ftree = None
        if ftree is not None:
            for node in ftree.body:
                tgt = None
                if isinstance(node, ast.Assign) and len(node.targets) \
                        == 1 and isinstance(node.targets[0], ast.Name):
                    tgt = node.targets[0].id
                elif isinstance(node, ast.AnnAssign) and \
                        isinstance(node.target, ast.Name):
                    tgt = node.target.id
                value = getattr(node, "value", None)
                if tgt == "BURST_ID_BASE" and \
                        isinstance(value, ast.Constant) and \
                        isinstance(value.value, int):
                    py_burst_base = value.value
                elif tgt == "BURST_SOURCE_FIELDS" and \
                        isinstance(value, ast.List):
                    py_burst_srcs = {
                        e.value for e in value.elts
                        if isinstance(e, ast.Constant)
                        and isinstance(e.value, int)}
    cc_burst_base: Optional[int] = None
    cc_burst_srcs: Optional[Set[int]] = None
    if inc_text is not None:
        m_base = _CC_BURST_BASE_RE.search(inc_text)
        if m_base:
            cc_burst_base = int(m_base.group(1))
        m_srcs = _CC_BURST_FIELDS_RE.search(inc_text)
        if m_srcs:
            cc_burst_srcs = {int(x) for x in
                             m_srcs.group(1).split(",") if x.strip()}
    if (py_burst_base is None) != (cc_burst_base is None):
        side = "tpumon_torch/fields.py" if py_burst_base is None \
            else "tpumon_torch/native/agent/catalog.inc"
        out.append(Finding(
            side, 0, "wire-constant-sync",
            "burst id-base declared on only one side (fields.py "
            "BURST_ID_BASE vs catalog.inc kBurstIdBase) — run "
            "python -m tpumon_torch.native.gen_catalog_header"))
    elif py_burst_base is not None and py_burst_base != cc_burst_base:
        out.append(Finding(
            "tpumon_torch/native/agent/catalog.inc", 0, "wire-constant-sync",
            f"kBurstIdBase {cc_burst_base} != fields.py BURST_ID_BASE "
            f"{py_burst_base} — every derived field id would decode "
            f"to the wrong source"))
    if (py_burst_srcs is None) != (cc_burst_srcs is None):
        side = "tpumon_torch/fields.py" if py_burst_srcs is None \
            else "tpumon_torch/native/agent/catalog.inc"
        out.append(Finding(
            side, 0, "wire-constant-sync",
            "burst source-field list declared on only one side "
            "(fields.py BURST_SOURCE_FIELDS vs catalog.inc "
            "kBurstSourceFields) — run python -m "
            "tpumon_torch.native.gen_catalog_header"))
    elif py_burst_srcs is not None and cc_burst_srcs is not None and \
            not cc_burst_srcs <= py_burst_srcs:
        out.append(Finding(
            "tpumon_torch/native/agent/catalog.inc", 0, "wire-constant-sync",
            f"C++ burst source field(s) "
            f"{sorted(cc_burst_srcs - py_burst_srcs)} are not in "
            f"fields.py BURST_SOURCE_FIELDS — the daemon would emit "
            f"derived ids the Python catalog cannot name"))

    # integral-dump limit: Python NUM_INT_LIMIT == the C++ constant,
    # and protocol.md mentions it
    limit = None
    for node in sf_tree.body:
        if isinstance(node, ast.Assign) and \
                isinstance(node.targets[0], ast.Name) and \
                node.targets[0].id == "NUM_INT_LIMIT" and \
                isinstance(node.value, ast.Constant):
            limit = float(node.value.value)  # type: ignore[arg-type]
    if limit is not None:
        # the predicate lives in sampler.hpp (burst_dumps_as_int, the
        # one emission predicate) since the burst engine; accept the
        # literal in either C++ file
        cc_all = main_cc + (read_opt("tpumon_torch/native/agent/sampler.hpp") or "")
        if not _INT_LIMIT_RE.search(cc_all):
            out.append(Finding(
                "tpumon_torch/native/agent/main.cc", 0, "wire-constant-sync",
                f"NUM_INT_LIMIT {limit:g} has no matching literal in "
                f"the C++ integral-dump rule (main.cc/sampler.hpp)"))
        if not _INT_LIMIT_RE.search(proto_md):
            out.append(Finding(
                "tpumon_torch/native/agent/protocol.md", 0, "wire-constant-sync",
                f"NUM_INT_LIMIT {limit:g} is not documented in the "
                f"number-convention section"))

    # -- native shared codec core ----------------------------------------------
    # The extension's compiled constants (tpumon_torch/native/codec/
    # core.hpp, which module.cc re-exports verbatim) must agree with the Python
    # declarations: frame magics, the integral-dump limit, the burst
    # id base, and the frame/value field numbers of the reference
    # layout.  Optional file: a tree without the native core has
    # nothing to pin (the facade falls back to the reference).
    # the protobuf walkers' varint cap: the Python twin (wire.py) and the
    # agent's request reader (wire.hpp) must give up on the same length,
    # or a request one accepts is malformed to the other.  Optional
    # files, like the codec core below.
    wire_py = read_opt(PKG + "/wire.py")
    wire_hpp = read_opt(NATIVE_DIR + "/agent/wire.hpp")
    if wire_py is not None and wire_hpp is not None:
        m_py = _PY_VARINT_CAP_RE.search(wire_py)
        m_cc = _CC_VARINT_CAP_RE.search(wire_hpp)
        if m_py is None or m_cc is None:
            out.append(Finding(
                NATIVE_DIR + "/agent/wire.hpp", 0, "wire-constant-sync",
                "the varint length cap was not found in wire.py/wire.hpp "
                "— the walker cross-check cannot run"))
        elif m_py.group(1) != m_cc.group(1):
            out.append(Finding(
                NATIVE_DIR + "/agent/wire.hpp", 0, "wire-constant-sync",
                f"wire.hpp caps a varint at {m_cc.group(1)} bytes but "
                f"wire.py at {m_py.group(1)} — one side would accept a "
                f"request the other rejects"))

    # the built extension's exported constants: the same pins as
    # core.hpp's source above, on what the loader would actually serve
    consts = codec_constants if codec_constants is not None \
        else built_codec_constants(repo)
    if consts:
        pins: List[Tuple[str, Optional[float]]] = [
            ("SWEEP_REQ_MAGIC", py_magics.get("SWEEP_REQ_MAGIC")),
            ("SWEEP_FRAME_MAGIC", py_magics.get("SWEEP_FRAME_MAGIC")),
            ("BURST_ID_BASE", py_burst_base),
            ("NUM_INT_LIMIT", limit)]
        pins += [(f"{kind.upper()}_FIELD_{name.upper()}", want)
                 for (kind, name), want in _CODEC_FIELD_LAYOUT.items()]
        for name, want in pins:
            got = consts.get(name)
            if want is None:
                continue
            if got is None or float(got) != float(want):
                out.append(Finding(
                    CODEC_MODULE_SRC, 0, "wire-constant-sync",
                    f"the built {CODEC_EXTENSION} exports {name} = {got!r} "
                    f"but the Python declaration is {want!r} — a stale or "
                    f"drifted build; rebuild with python -m "
                    f"tpumon_torch._build --native"))
    core_cc = read_opt("tpumon_torch/native/codec/core.hpp")
    if core_cc is not None:
        core_magics = {m.group(1): int(m.group(2), 16)
                       for m in _CC_MAGIC_RE.finditer(core_cc)}
        for py_name, cc_name in (("SWEEP_REQ_MAGIC", "SweepReqMagic"),
                                 ("SWEEP_FRAME_MAGIC",
                                  "SweepFrameMagic")):
            pv = py_magics.get(py_name)
            cv = core_magics.get(cc_name)
            if pv is None or cv is None:
                out.append(Finding(
                    "tpumon_torch/native/codec/core.hpp", 0, "wire-constant-sync",
                    f"{py_name}/k{cc_name} not found in sweepframe.py/"
                    f"core.hpp — the native-codec magic cross-check "
                    f"cannot run"))
            elif pv != cv:
                out.append(Finding(
                    "tpumon_torch/native/codec/core.hpp", 0, "wire-constant-sync",
                    f"native codec k{cc_name} is {cv:#x} but "
                    f"sweepframe.py {py_name} is {pv:#x} — the "
                    f"extension would emit unframeable bytes"))
        if limit is not None and not _INT_LIMIT_RE.search(core_cc):
            out.append(Finding(
                "tpumon_torch/native/codec/core.hpp", 0, "wire-constant-sync",
                f"NUM_INT_LIMIT {limit:g} has no matching literal in "
                f"the native codec core (kNumIntLimit)"))
        m_base = _CC_BURST_BASE_RE.search(core_cc)
        if py_burst_base is not None:
            if m_base is None:
                out.append(Finding(
                    "tpumon_torch/native/codec/core.hpp", 0, "wire-constant-sync",
                    "kBurstIdBase not found in the native codec core — "
                    "the extension's burst harvest ids cannot be "
                    "cross-checked"))
            elif int(m_base.group(1)) != py_burst_base:
                out.append(Finding(
                    "tpumon_torch/native/codec/core.hpp", 0, "wire-constant-sync",
                    f"native codec kBurstIdBase {m_base.group(1)} != "
                    f"fields.py BURST_ID_BASE {py_burst_base} — every "
                    f"native-harvested derived id would be wrong"))
        # frame/value field numbers: the named constants vs the
        # reference wire layout (protocol.md value-entry table; the
        # Python reference writes these as literals, pinned by the
        # inline-tag clause above)
        core_fields = {
            (m.group(1), m.group(2)): int(m.group(3))
            for m in _CC_NAMED_FIELD_RE.finditer(core_cc)}
        for key, want in _CODEC_FIELD_LAYOUT.items():
            got = core_fields.get(key)
            if got is None:
                out.append(Finding(
                    "tpumon_torch/native/codec/core.hpp", 0, "wire-constant-sync",
                    f"k{key[0]}Field{key[1]} not declared in the "
                    f"native codec core — the field-number cross-check "
                    f"cannot run"))
            elif got != want:
                out.append(Finding(
                    "tpumon_torch/native/codec/core.hpp", 0, "wire-constant-sync",
                    f"native codec k{key[0]}Field{key[1]} is {got} but "
                    f"the reference layout (protocol.md / "
                    f"sweepframe.py) uses {want}"))
    return out


# -- pass 5: exception flow + resource lifetime --------------------------------

#: a compact builtin-exception hierarchy (child -> parent), extended at
#: analysis time with repo-defined exception classes — enough for the
#: raise-set filter to know a ``raise BrokenPipeError`` is handled by
#: ``except OSError:`` without modeling the full type system
_EXC_PARENTS: Dict[str, str] = {
    "BrokenPipeError": "ConnectionError",
    "ConnectionResetError": "ConnectionError",
    "ConnectionAbortedError": "ConnectionError",
    "ConnectionRefusedError": "ConnectionError",
    "ConnectionError": "OSError",
    "TimeoutError": "OSError",
    "FileNotFoundError": "OSError",
    "FileExistsError": "OSError",
    "PermissionError": "OSError",
    "InterruptedError": "OSError",
    "IsADirectoryError": "OSError",
    "NotADirectoryError": "OSError",
    "BlockingIOError": "OSError",
    "ChildProcessError": "OSError",
    "ProcessLookupError": "OSError",
    "error": "OSError",            # socket.error alias
    "gaierror": "OSError",
    "herror": "OSError",
    "timeout": "OSError",          # socket.timeout alias
    "IndexError": "LookupError",
    "KeyError": "LookupError",
    "UnicodeDecodeError": "ValueError",
    "UnicodeEncodeError": "ValueError",
    "RecursionError": "RuntimeError",
    "NotImplementedError": "RuntimeError",
    "OSError": "Exception",
    "ValueError": "Exception",
    "TypeError": "Exception",
    "RuntimeError": "Exception",
    "LookupError": "Exception",
    "AttributeError": "Exception",
    "StopIteration": "Exception",
    "ArithmeticError": "Exception",
    "ZeroDivisionError": "ArithmeticError",
    "OverflowError": "ArithmeticError",
}


def _exc_parent_table(g: Graph) -> Dict[str, str]:
    """The builtin hierarchy plus repo-defined exception classes
    (``class FrameError(ValueError)`` links FrameError under
    ValueError, so ``except ValueError:`` handles it)."""

    parents = dict(_EXC_PARENTS)
    for ci in g.classes.values():
        for b in ci.base_names:
            nm = b.id if isinstance(b, ast.Name) else (
                b.attr if isinstance(b, ast.Attribute) else "")
            if nm and (nm in parents
                       or nm in ("Exception", "BaseException")
                       or nm.endswith("Error")):
                parents.setdefault(ci.name, nm)
                break
    return parents


def _caught_matches(caught: Sequence[str], exc: str,
                    parents: Dict[str, str]) -> bool:
    """True when an enclosing handler set ``caught`` handles ``exc``
    (exact name, an ancestor per the hierarchy table, or a catch-all
    Exception/BaseException handler)."""

    if not caught:
        return False
    for c in caught:
        if c in ("Exception", "BaseException"):
            return True
        e: Optional[str] = exc
        seen: Set[str] = set()
        while e is not None and e not in seen:
            if e == c:
                return True
            seen.add(e)
            e = parents.get(e)
    return False


def compute_raise_sets(g: Graph) -> Dict[str, FrozenSet[str]]:
    """Exception names that can ESCAPE each function: explicit raise
    statements not caught by an enclosing handler in the same
    function, plus every callee's escape set filtered through the
    ``except`` clauses wrapped around the call site — a fixpoint over
    the call graph (the interprocedural raise-set propagation)."""

    parents = _exc_parent_table(g)
    rs: Dict[str, Set[str]] = {q: set() for q in g.funcs}
    for q, fi in g.funcs.items():
        for _line, name, caught in fi.raises:
            if not _caught_matches(caught, name, parents):
                rs[q].add(name)
    changed = True
    rounds = 0
    while changed and rounds < 50:
        changed = False
        rounds += 1
        for q, fi in g.funcs.items():
            cur = rs[q]
            for callee, _line, caught in fi.calls_caught:
                cs = rs.get(callee)
                if not cs:
                    continue
                add = {e for e in cs
                       if not _caught_matches(caught, e, parents)}
                if not add <= cur:
                    cur |= add
                    changed = True
    return {q: frozenset(v) for q, v in rs.items()}


def raise_report(g: Graph,
                 manifest: Optional[Dict[str, List[str]]] = None,
                 ) -> Dict[str, List[str]]:
    """Root -> exceptions that can escape it — the ``--json``
    surface of the raise-set fixpoint, bounded to the hot roots."""

    manifest = HOT_ROOTS if manifest is None else manifest
    rs = compute_raise_sets(g)
    out: Dict[str, List[str]] = {}
    for roots in manifest.values():
        for r in roots:
            if r in g.funcs:
                out[r] = sorted(rs.get(r, frozenset()))
    return out


def _own_nodes(fn: ast.AST) -> Iterator[ast.AST]:
    """Every AST node of a function EXCLUDING nested function/class
    scopes and lambda bodies — those are analyzed as their own
    functions (or belong to another scope entirely)."""

    stack: List[ast.AST] = list(getattr(fn, "body", []))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _stmts_span(stmts: Sequence[ast.stmt]) -> Optional[Tuple[int, int]]:
    if not stmts:
        return None
    return (stmts[0].lineno,
            max((getattr(s, "end_lineno", None) or s.lineno)
                for s in stmts))


@dataclass
class _GuardRanges:
    """Line ranges of one function's exception/loop structure — the
    approximation the lifetime rules use for 'is this site protected
    against an in-flight exception'."""

    handler: List[Tuple[int, int]] = dc_field(default_factory=list)
    trybody: List[Tuple[int, int]] = dc_field(default_factory=list)
    loop: List[Tuple[int, int]] = dc_field(default_factory=list)
    suppress: List[Tuple[int, int]] = dc_field(default_factory=list)
    #: (then-span, else-span) per ``if`` with both branches — two
    #: lines in opposite branches can never execute together
    branches: List[Tuple[Tuple[int, int], Tuple[int, int]]] = \
        dc_field(default_factory=list)

    def exclusive(self, a: int, b: int) -> bool:
        """True when lines ``a`` and ``b`` sit in opposite branches of
        some ``if``/``else`` (so one can never raise 'before' the
        other at runtime)."""

        for then_span, else_span in self.branches:
            if (_in_ranges(a, (then_span,)) and _in_ranges(b, (else_span,))) \
                    or (_in_ranges(a, (else_span,))
                        and _in_ranges(b, (then_span,))):
                return True
        return False


def _in_ranges(line: int, ranges: Sequence[Tuple[int, int]]) -> bool:
    return any(lo <= line <= hi for lo, hi in ranges)


def _guard_ranges(fn: ast.AST) -> _GuardRanges:
    gr = _GuardRanges()
    for node in _own_nodes(fn):
        if isinstance(node, ast.Try):
            for h in node.handlers:
                span = _stmts_span(h.body)
                if span:
                    gr.handler.append(span)
            span = _stmts_span(node.finalbody)
            if span:
                gr.handler.append(span)
            # a try body is protected by its handlers OR its finally:
            # either way, a raise inside it still runs the teardown
            # statements that follow in the finally/handler
            if node.handlers or node.finalbody:
                span = _stmts_span(node.body)
                if span:
                    gr.trybody.append(span)
        elif isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
            span = _stmts_span(list(node.body) + list(node.orelse))
            if span:
                gr.loop.append(span)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            if any(_ctor_name(item.context_expr) == "suppress"
                   for item in node.items):
                span = _stmts_span(node.body)
                if span:
                    gr.suppress.append(span)
        elif isinstance(node, ast.If):
            then_span = _stmts_span(node.body)
            else_span = _stmts_span(node.orelse)
            if then_span and else_span:
                gr.branches.append((then_span, else_span))
    return gr


#: method names whose call releases a registry resource
_RELEASE_METHODS = frozenset({
    "close", "stop", "shutdown", "join", "cancel", "terminate", "kill",
})

#: socket-acquiring constructors (the affine set plus fd adopters)
_RESOURCE_SOCKET_CTORS = _AFFINE_SOCKET_CTORS | {"fromfd", "dup"}

#: file-acquiring callables
_RESOURCE_FILE_FUNCS = frozenset({"open", "fdopen"})

#: callables that provably cannot raise in practice (sync primitives,
#: container constructors, clocks) — excluded from the 'can this
#: statement raise' risk set so straight-line init code does not flag
#: on a threading.Lock() between acquire and handoff
_SAFE_CALLS = frozenset({
    "Lock", "RLock", "Event", "Condition", "Semaphore",
    "BoundedSemaphore", "Barrier", "Queue", "SimpleQueue", "LifoQueue",
    "PriorityQueue", "deque", "defaultdict", "OrderedDict", "Counter",
    "dict", "list", "set", "tuple", "frozenset", "bytearray",
    "monotonic", "time", "perf_counter", "len", "id", "repr", "str",
    "bool", "range", "enumerate", "zip", "getLogger", "super", "copy",
    "get", "items", "keys", "values", "append", "extend", "clear",
    "setdefault", "field", "isinstance", "hasattr", "format",
} | _RELEASE_METHODS)


def _resource_kind(g: Graph, mi: ModuleInfo,
                   value: ast.expr) -> Optional[str]:
    """A short kind string when ``value`` constructs a must-close
    resource: 'socket', 'selector', 'file', 'thread', or the name of a
    repo class that defines (or inherits) close()/stop()."""

    if not isinstance(value, ast.Call):
        return None
    name = _ctor_name(value)
    if name is None:
        return None
    if name.endswith("Selector"):
        return "selector"
    if name in _RESOURCE_SOCKET_CTORS:
        return "socket"
    if name in _RESOURCE_FILE_FUNCS:
        return "file"
    if name == "Thread":
        return "thread"
    q = _resolve_class_expr(g, mi, value.func)
    if q and q != EXTERNAL and q in g.classes:
        for c in _class_chain(g, q):
            if "close" in c.methods or "stop" in c.methods:
                return q.rsplit("::", 1)[-1].rsplit(".", 1)[-1]
    return None


def _call_terminal(node: ast.Call) -> str:
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def _pass5_sup_lines(fi: FuncInfo, line: int) -> Tuple[int, ...]:
    """The lines a ``close-ok`` pragma may sit on for a site: the site
    itself, the line above it, the enclosing def header, or the line
    above the def — same convention as ``thread-ok``."""

    lines = (line, line - 1) + tuple(fi.def_lines)
    if fi.def_lines:
        lines += (min(fi.def_lines) - 1,)
    return lines


def _name_in(var: str, node: ast.AST) -> bool:
    return any(isinstance(s, ast.Name) and s.id == var
               for s in ast.walk(node))


def _scan_function_lifetime(g: Graph, mi: ModuleInfo, fi: FuncInfo,
                            supp: Optional[Suppressions],
                            out: List[Finding]) -> None:
    """Local must-close analysis: every resource bound to a local name
    must reach a release (close/stop/join/with-exit) or a handoff
    (stored, passed, returned) on every path — and when a raising call
    sits between acquire and the first release/handoff with no
    exception-protected release anywhere, the exceptional path leaks
    it."""

    fn = fi.node
    acqs: List[Tuple[str, int, str]] = []
    for node in _own_nodes(fn):
        if isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Call):
            kind = _resource_kind(g, mi, node.value)
            if kind is None:
                continue
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    acqs.append((tgt.id, node.lineno, kind))
                elif isinstance(tgt, ast.Tuple):
                    # a, b = socket.socketpair(): both ends must close
                    for el in tgt.elts:
                        if isinstance(el, ast.Name):
                            acqs.append((el.id, node.lineno, kind))
    if not acqs:
        return
    guards = _guard_ranges(fn)
    calls = [(node.lineno, _call_terminal(node))
             for node in _own_nodes(fn) if isinstance(node, ast.Call)]
    for var, aline, kind in acqs:
        releases: List[int] = []
        escapes: List[int] = []
        protected = False
        for node in _own_nodes(fn):
            if isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Attribute) and \
                        isinstance(f.value, ast.Name) and \
                        f.value.id == var and f.attr in _RELEASE_METHODS:
                    releases.append(node.lineno)
                    if _in_ranges(node.lineno, guards.handler) or \
                            _in_ranges(node.lineno, guards.suppress):
                        protected = True
                    continue
                for a in list(node.args) + \
                        [k.value for k in node.keywords]:
                    if _name_in(var, a):
                        escapes.append(node.lineno)
                        # a handoff inside an except handler IS the
                        # exceptional-path release (e.g. a
                        # close_quietly(sock) helper in the handler)
                        if _in_ranges(node.lineno, guards.handler) or \
                                _in_ranges(node.lineno,
                                           guards.suppress):
                            protected = True
                        break
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    if isinstance(item.context_expr, ast.Name) and \
                            item.context_expr.id == var:
                        # `with sock:` — __exit__ runs on every path
                        releases.append(node.lineno)
                        protected = True
            elif isinstance(node, ast.Return):
                if node.value is not None and _name_in(var, node.value):
                    escapes.append(node.lineno)
            elif isinstance(node, (ast.Yield, ast.YieldFrom)):
                if node.value is not None and _name_in(var, node.value):
                    escapes.append(node.lineno)
            elif isinstance(node, ast.Assign) and node.lineno != aline:
                if _name_in(var, node.value):
                    escapes.append(node.lineno)
                for t in node.targets:
                    if isinstance(t, ast.Name) and t.id == var:
                        # rebind: tracking of the old value ends here
                        escapes.append(node.lineno)
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)) and \
                    node.value is not None and node.lineno != aline:
                if _name_in(var, node.value):
                    escapes.append(node.lineno)
            elif isinstance(node, ast.Raise):
                if node.exc is not None and _name_in(var, node.exc):
                    escapes.append(node.lineno)
        if supp is not None and supp.suppressed(
                "leak-on-exceptional-path", None,
                *_pass5_sup_lines(fi, aline)):
            continue
        outs = sorted(set(releases) | set(escapes))
        if not outs:
            out.append(Finding(
                fi.rel, aline, "leak-on-exceptional-path",
                f"{kind} {var!r} acquired here never reaches "
                f"close()/with-exit and is never handed off — it "
                f"leaks on every path; close it, store it, or "
                f"suppress with '# tpumon: close-ok(reason)'"))
            continue
        if protected:
            continue
        later = [ln for ln in outs if ln > aline]
        if not later:
            continue  # release precedes acquire lexically: loop shape
        first_out = later[0]
        skip_lines = set(releases) | set(escapes)
        # a call in an except-handler body runs only after the
        # protected work ALREADY raised, and a call in the opposite
        # branch of an ``if`` never runs with the acquisition — neither
        # sits on the acquire-to-release path
        risky = [ln for ln, nm in calls
                 if aline < ln < first_out and ln not in skip_lines
                 and nm not in _SAFE_CALLS
                 and not _in_ranges(ln, guards.handler)
                 and not guards.exclusive(aline, ln)]
        if risky:
            out.append(Finding(
                fi.rel, aline, "leak-on-exceptional-path",
                f"{kind} {var!r}: the call at line {min(risky)} can "
                f"raise before the close/handoff at line {first_out}, "
                f"leaking the resource on the exceptional path — wrap "
                f"in try/except (close, then re-raise), use `with`, "
                f"or suppress with '# tpumon: close-ok(reason)'"))


def _scan_init_lifetime(g: Graph, mi: ModuleInfo, fi: FuncInfo,
                        supp: Optional[Suppressions],
                        out: List[Finding]) -> None:
    """Partial-constructor analysis: after ``__init__`` assigns a
    resource member, any later statement that can raise must be
    covered by a handler (or finally) that releases the
    already-acquired members — otherwise a failed constructor leaks
    them (the object is never returned, so no one can close it)."""

    fn = fi.node
    members: List[Tuple[int, str, str]] = []
    for node in _own_nodes(fn):
        if isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Call):
            kind = _resource_kind(g, mi, node.value)
            if kind is None:
                continue
            for tgt in node.targets:
                if isinstance(tgt, ast.Attribute) and \
                        isinstance(tgt.value, ast.Name) and \
                        tgt.value.id == "self":
                    members.append((node.lineno, tgt.attr, kind))
                elif isinstance(tgt, ast.Tuple):
                    for el in tgt.elts:
                        if isinstance(el, ast.Attribute) and \
                                isinstance(el.value, ast.Name) and \
                                el.value.id == "self":
                            members.append((node.lineno, el.attr, kind))
    if not members:
        return
    members.sort()
    guards = _guard_ranges(fn)
    # try bodies whose handlers/finally contain a release-shaped call
    # protect the statements they cover
    protect: List[Tuple[int, int]] = []
    for node in _own_nodes(fn):
        if not isinstance(node, ast.Try):
            continue
        cleanup = False
        for stmts in [h.body for h in node.handlers] + [node.finalbody]:
            for s in stmts:
                for sub in ast.walk(s):
                    if isinstance(sub, ast.Call):
                        nm = _call_terminal(sub)
                        if nm in _RELEASE_METHODS or "close" in nm or \
                                "release" in nm or "cleanup" in nm:
                            cleanup = True
        if cleanup:
            span = _stmts_span(node.body)
            if span:
                protect.append(span)
    first_line = members[0][0]
    for line, nm in sorted(
            (node.lineno, _call_terminal(node))
            for node in _own_nodes(fn) if isinstance(node, ast.Call)):
        if line <= first_line or nm in _SAFE_CALLS:
            continue
        if _in_ranges(line, protect) or _in_ranges(line, guards.handler):
            continue
        acquired = sorted({attr for ml, attr, _k in members
                           if ml < line})
        if not acquired:
            continue
        if supp is not None and supp.suppressed(
                "partial-init-leak", None, *_pass5_sup_lines(fi, line)):
            return
        names = ", ".join(f"self.{a}" for a in acquired)
        out.append(Finding(
            fi.rel, line, "partial-init-leak",
            f"__init__ already acquired {names} when this call runs — "
            f"a raise here leaks them (the half-built object is never "
            f"returned, so nothing can close it); wrap the rest of "
            f"__init__ in try/except releasing the acquired members, "
            f"or suppress with '# tpumon: close-ok(reason)'"))
        return


#: method names that shape a teardown path (the close-shaped methods
#: the aggregation and swallow rules cover)
_CLOSE_SHAPED = frozenset({"close", "stop", "__exit__", "__del__"})


def _is_member_release(node: ast.Call) -> Optional[str]:
    """A short receiver description when ``node`` releases a member
    resource inside a teardown method (never ``self.x()`` delegation,
    never str/path ``join``)."""

    f = node.func
    if not isinstance(f, ast.Attribute) or \
            f.attr not in _RELEASE_METHODS:
        return None
    recv = f.value
    if isinstance(recv, ast.Name) and recv.id == "self":
        return None                 # self.stop() delegation
    if isinstance(recv, ast.Constant):
        return None                 # ", ".join(...)
    if f.attr == "join":
        # thread.join([timeout]) vs str/os.path join: a join with a
        # non-trivial argument list is a string/path join
        if isinstance(recv, ast.Attribute) and recv.attr == "path":
            return None
        if isinstance(recv, ast.Name) and recv.id in ("path", "os"):
            return None
        args = list(node.args) + [k.value for k in node.keywords]
        if len(args) > 1:
            return None
        if args and not isinstance(args[0], (ast.Constant, ast.Name,
                                             ast.Attribute)):
            return None
    if isinstance(recv, ast.Attribute) and \
            isinstance(recv.value, ast.Name) and recv.value.id == "self":
        return f"self.{recv.attr}"
    if isinstance(recv, ast.Name):
        return recv.id
    return "<member>"


def _scan_close_aggregation(g: Graph, mi: ModuleInfo, fi: FuncInfo,
                            supp: Optional[Suppressions],
                            out: List[Finding]) -> None:
    """Exception-aggregation analysis for close()-shaped methods: a
    member close that can raise must not skip the remaining member
    closes — each release is wrapped (try/except, contextlib.suppress)
    or it is the lexically last one."""

    fn = fi.node
    guards = _guard_ranges(fn)
    sites: List[Tuple[int, str, str, bool, bool]] = []
    for node in _own_nodes(fn):
        if not isinstance(node, ast.Call):
            continue
        desc = _is_member_release(node)
        if desc is None:
            continue
        prot = (_in_ranges(node.lineno, guards.trybody)
                or _in_ranges(node.lineno, guards.handler)
                or _in_ranges(node.lineno, guards.suppress))
        sites.append((node.lineno, desc,
                      node.func.attr,  # type: ignore[attr-defined]
                      prot, _in_ranges(node.lineno, guards.loop)))
    if not sites:
        return
    sites.sort()
    last_line = sites[-1][0]
    for line, desc, meth, prot, in_loop in sites:
        if prot:
            continue
        if not in_loop and line >= last_line:
            continue                # nothing after it to skip
        if supp is not None and supp.suppressed(
                "close-not-aggregating", None,
                *_pass5_sup_lines(fi, line)):
            continue
        what = ("the remaining loop iterations and member closes"
                if in_loop else "the remaining member closes")
        out.append(Finding(
            fi.rel, line, "close-not-aggregating",
            f"{desc}.{meth}() in this teardown can raise and would "
            f"skip {what} — wrap each member release in try/except "
            f"(collect, release the rest, then re-raise), or "
            f"suppress with '# tpumon: close-ok(reason)'"))
        return


def _broad_handler(h: ast.ExceptHandler) -> Optional[str]:
    t = h.type
    if t is None:
        return "bare `except:`"
    parts = t.elts if isinstance(t, ast.Tuple) else [t]
    for p in parts:
        nm = p.id if isinstance(p, ast.Name) else (
            p.attr if isinstance(p, ast.Attribute) else "")
        if nm in ("Exception", "BaseException"):
            return f"`except {nm}:`"
    return None


def _silent_handler(h: ast.ExceptHandler) -> bool:
    """True when the handler body visibly does nothing: no call (log,
    cleanup), no raise, no assignment — just pass/constants/control
    flow."""

    for s in h.body:
        for sub in ast.walk(s):
            if isinstance(sub, (ast.Call, ast.Raise, ast.Assign,
                                ast.AugAssign, ast.AnnAssign)):
                return False
    return True


def _scan_swallow(g: Graph, mi: ModuleInfo, fi: FuncInfo,
                  supp: Optional[Suppressions], why: str,
                  out: List[Finding]) -> None:
    for node in _own_nodes(fi.node):
        if not isinstance(node, ast.Try):
            continue
        for h in node.handlers:
            what = _broad_handler(h)
            if what is None or not _silent_handler(h):
                continue
            if supp is not None and supp.suppressed(
                    "swallowed-exception", "silent-except",
                    *_pass5_sup_lines(fi, h.lineno)):
                continue
            out.append(Finding(
                fi.rel, h.lineno, "swallowed-exception",
                f"{what} {why} swallows the failure invisibly — "
                f"log via tpumon_torch.log.warn_every/vlog, narrow the "
                f"type, or suppress with "
                f"'# tpumon: close-ok(reason)'"))


def check_lifetimes(g: Graph,
                    manifest: Optional[Dict[str, List[str]]] = None,
                    ignore_suppressions: bool = False) -> List[Finding]:
    """Pass 5: exception-flow + resource-lifetime rules, repo-wide for
    the lifetime rules (a leak is a leak on any path) and scoped to
    the hot closure + teardown methods for the swallow rule."""

    manifest = HOT_ROOTS if manifest is None else manifest
    out: List[Finding] = []
    hot: Set[str] = set()
    hot_via: Dict[str, str] = {}
    for roots in manifest.values():
        for r in roots:
            for q in reachable(g, [r]):
                hot.add(q)
                hot_via.setdefault(q, r)
    for q, fi in sorted(g.funcs.items()):
        mi = g.modules[fi.rel]
        supp = None if ignore_suppressions else mi.supp
        _scan_function_lifetime(g, mi, fi, supp, out)
        if fi.cls is not None and fi.name == "__init__":
            _scan_init_lifetime(g, mi, fi, supp, out)
        teardown = fi.cls is not None and fi.name in _CLOSE_SHAPED
        if teardown:
            _scan_close_aggregation(g, mi, fi, supp, out)
        if teardown or q in hot:
            why = ("on the teardown path" if teardown else
                   f"on the hot path (reachable from {hot_via.get(q)})")
            _scan_swallow(g, mi, fi, supp, why, out)
    return out


# -- pass 6: effect-budget inference -------------------------------------------

#: builtins whose call allocates a fresh container per call — the
#: no-alloc budget's call half (displays/comprehensions are flagged
#: structurally)
_EFFECT_ALLOC_CALLS = frozenset({
    "list", "dict", "set", "tuple", "sorted", "bytearray", "frozenset",
    "deepcopy",
})


def local_effects(g: Graph, mi: ModuleInfo, fi: FuncInfo,
                  parents: Dict[str, str],
                  ) -> Dict[str, List[Tuple[int, str]]]:
    """The function's LOCAL effect sites per kind (line, what) —
    reachability does the interprocedural half: a budget violation is
    a local effect in any function of the budget root's closure."""

    eff: Dict[str, List[Tuple[int, str]]] = {k: [] for k in EFFECT_KINDS}
    ci = g.classes.get(fi.cls) if fi.cls else None
    for node in _own_nodes(fi.node):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                lid = _lock_id(g, mi, ci, fi, item.context_expr)
                if lid is not None:
                    eff["lock"].append(
                        (item.context_expr.lineno,
                         f"`with {_short_lock(lid)}`"))
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            eff["alloc"].append((node.lineno,
                                 "a comprehension allocation"))
        elif isinstance(node, (ast.List, ast.Set)):
            eff["alloc"].append((node.lineno, "a container display"))
        elif isinstance(node, ast.Dict):
            eff["alloc"].append((node.lineno, "a dict display"))
        elif isinstance(node, ast.Call):
            f = node.func
            nm = _call_terminal(node)
            if nm == "acquire" and isinstance(f, ast.Attribute):
                eff["lock"].append((node.lineno, ".acquire()"))
            elif isinstance(f, ast.Name) and nm in _EFFECT_ALLOC_CALLS:
                eff["alloc"].append((node.lineno, f"{nm}()"))
            if isinstance(f, ast.Name) and nm in _RESOURCE_FILE_FUNCS:
                eff["syscall"].append((node.lineno, f"{nm}()"))
            elif isinstance(f, ast.Attribute) and \
                    isinstance(f.value, ast.Name):
                if f.value.id == "os":
                    eff["syscall"].append((node.lineno, f"os.{nm}()"))
                elif f.value.id == "subprocess":
                    eff["syscall"].append(
                        (node.lineno, f"subprocess.{nm}()"))
                elif f.value.id == "socket" and \
                        nm in _RESOURCE_SOCKET_CTORS:
                    eff["syscall"].append(
                        (node.lineno, f"socket.{nm}()"))
            elif isinstance(f, ast.Name) and nm == "print":
                eff["syscall"].append((node.lineno, "print()"))
    for line, _end, what, _held in fi.blocking:
        eff["blocking"].append((line, what))
    for line, name, caught in fi.raises:
        if not _caught_matches(caught, name, parents):
            eff["raise"].append((line, f"raise {name}"))
    return eff


def effect_signature_table(g: Graph,
                           manifest: Optional[Dict[str, List[str]]]
                           = None) -> Dict[str, List[str]]:
    """Root -> the effect kinds present anywhere in its closure (raw,
    pre-suppression) — the per-root effect signature the ``--json``
    artifact publishes next to the guarded-by and raises tables."""

    manifest = HOT_ROOTS if manifest is None else manifest
    parents = _exc_parent_table(g)
    table: Dict[str, List[str]] = {}
    for roots in manifest.values():
        for r in roots:
            if r not in g.funcs:
                continue
            kinds: Set[str] = set()
            for q in reachable(g, [r]):
                fi = g.funcs[q]
                eff = local_effects(g, g.modules[fi.rel], fi, parents)
                kinds |= {k for k, sites in eff.items() if sites}
            table[r] = sorted(kinds)
    return table


def check_effects(g: Graph,
                  budgets: Optional[Dict[str, Dict[str, Sequence[str]]]]
                  = None,
                  ignore_suppressions: bool = False) -> List[Finding]:
    """Pass 6: per-function effect signatures joined with the declared
    per-root budgets — a forbidden effect anywhere in a budgeted
    root's closure is a finding at the effect site."""

    budgets = EFFECT_BUDGETS if budgets is None else budgets
    parents = _exc_parent_table(g)
    out: List[Finding] = []
    seen: Set[Tuple[str, int, str, str]] = set()
    for bname in sorted(budgets):
        spec = budgets[bname]
        roots = list(spec.get("roots", ()))
        forbid = tuple(spec.get("forbid", ()))
        unknown = [k for k in forbid if k not in EFFECT_KINDS]
        if unknown:
            raise ValueError(
                f"budget {bname!r} forbids unknown effect kind(s) "
                f"{unknown}; valid: {EFFECT_KINDS}")
        closure_via: Dict[str, str] = {}
        for r in roots:
            if r not in g.funcs:
                out.append(Finding(
                    r.split("::")[0], 0, "effect-root-missing",
                    f"effect-budget root {r!r} (budget {bname!r}) "
                    f"does not resolve — update EFFECT_BUDGETS or "
                    f"restore the function"))
                continue
            for q in reachable(g, [r]):
                closure_via.setdefault(q, r)
        for q in sorted(closure_via):
            fi = g.funcs[q]
            supp = None if ignore_suppressions else \
                g.modules[fi.rel].supp
            eff = local_effects(g, g.modules[fi.rel], fi, parents)
            for kind in forbid:
                for line, what in eff[kind]:
                    key = (fi.rel, line, kind, bname)
                    if key in seen:
                        continue
                    if supp is not None and supp.suppressed(
                            "effect-budget", None,
                            *_pass5_sup_lines(fi, line)):
                        continue
                    seen.add(key)
                    out.append(Finding(
                        fi.rel, line, "effect-budget",
                        f"{what} violates the {bname!r} no-{kind} "
                        f"budget (reachable from {closure_via[q]}) — "
                        f"the steady path declares it never performs "
                        f"this effect; move it off the hot path or "
                        f"suppress with '# tpumon: effect-ok(reason)'"))
    return out


# -- pass 7: the native analysis plane -----------------------------------------
#
# The same zero-dependency discipline as the Python passes, pointed at
# ``tpumon_torch/native/``: a hand-rolled C++ lexer (NOT a parser — brace/paren
# structure and token patterns carry every rule we need), a declaration
# index with a name-resolved call graph (conservative dynamic dispatch:
# a call edge goes to EVERY function of that name, the same fallback
# rule the Python graph uses), and four rule families on top.  The
# lexer handles line/block comments, string/char literals (escapes),
# raw strings and preprocessor lines; templates, overload sets and
# macros are deliberately approximated — every approximation errs
# toward silence on constructs the rules do not target, and the seeded
# fixtures in tests/test_native_check.py pin the constructs they do.

_CC_EXTS = (".cc", ".cpp", ".cxx", ".hpp", ".hh", ".h")

_CC_KEYWORDS = frozenset("""
    alignas alignof asm auto bool break case catch char char8_t
    char16_t char32_t class co_await co_return co_yield concept const
    consteval constexpr constinit const_cast continue decltype default
    delete do double dynamic_cast else enum explicit export extern
    false final float for friend goto if inline int long mutable
    namespace new noexcept nullptr operator override private protected
    public register reinterpret_cast requires return short signed
    sizeof static static_assert static_cast struct switch template
    this thread_local throw true try typedef typeid typename union
    unsigned using virtual void volatile wchar_t while
    """.split())

_CC_PUNCT3 = ("<<=", ">>=", "->*", "...")
_CC_PUNCT2 = ("::", "->", "<<", ">>", "<=", ">=", "==", "!=", "&&",
              "||", "++", "--", "+=", "-=", "*=", "/=", "%=", "&=",
              "|=", "^=", ".*")
_CC_RAW_PREFIXES = frozenset({"R", "u8R", "uR", "LR", "UR"})


def cc_lex(src: str) -> List[Tuple[str, str, int]]:
    """Tokenize C++ source into ``(kind, text, line)`` triples, kind in
    {"id", "num", "str", "punct"}.  Comments and preprocessor
    directives vanish (pragmas are read from the RAW source by
    ``Suppressions``, so ``// tpumon: ...`` comments still count).
    String/char tokens keep their contents behind a ``\\x00`` sentinel
    prefix (read them back via ``cc_str_text``) — so a literal like
    ``'{'`` or ``"=="`` can never masquerade as structural
    punctuation to the brace/paren walkers."""

    toks: List[Tuple[str, str, int]] = []
    i, n, line = 0, len(src), 1
    at_line_start = True
    while i < n:
        c = src[i]
        if c == "\n":
            line += 1
            at_line_start = True
            i += 1
            continue
        if c in " \t\r\f\v":
            i += 1
            continue
        if c == "/" and i + 1 < n and src[i + 1] == "/":
            j = src.find("\n", i)
            i = n if j < 0 else j
            continue
        if c == "/" and i + 1 < n and src[i + 1] == "*":
            j = src.find("*/", i + 2)
            if j < 0:
                break
            line += src.count("\n", i, j + 2)
            i = j + 2
            continue
        if c == "#" and at_line_start:
            # preprocessor directive: skip to end of line, honoring
            # backslash continuations
            while i < n:
                j = src.find("\n", i)
                if j < 0:
                    i = n
                    break
                k = j - 1
                if k >= 0 and src[k] == "\r":
                    k -= 1
                if k >= i and src[k] == "\\":
                    line += 1
                    i = j + 1
                    continue
                i = j          # leave the newline to the main loop
                break
            continue
        at_line_start = False
        if c == '"' or (c.isalpha() or c == "_"):
            if c != '"':
                j = i + 1
                while j < n and (src[j].isalnum() or src[j] == "_"):
                    j += 1
                ident = src[i:j]
                if (ident in _CC_RAW_PREFIXES and j < n
                        and src[j] == '"'):
                    # raw string literal R"delim( ... )delim"
                    p = src.find("(", j + 1)
                    if p < 0:
                        break
                    delim = src[j + 1:p]
                    close = src.find(")" + delim + '"', p + 1)
                    if close < 0:
                        break
                    body = src[p + 1:close]
                    toks.append(("str", "\x00" + body, line))
                    line += src.count("\n", i, close)
                    i = close + len(delim) + 2
                    continue
                toks.append(("id", ident, line))
                i = j
                continue
            j = i + 1
            buf: List[str] = []
            while j < n:
                ch = src[j]
                if ch == "\\" and j + 1 < n:
                    buf.append(src[j:j + 2])
                    j += 2
                    continue
                if ch == '"':
                    break
                if ch == "\n":     # unterminated: bail on this literal
                    break
                buf.append(ch)
                j += 1
            toks.append(("str", "\x00" + "".join(buf), line))
            i = j + 1
            continue
        if c == "'":
            j = i + 1
            while j < n:
                ch = src[j]
                if ch == "\\" and j + 1 < n:
                    j += 2
                    continue
                if ch == "'" or ch == "\n":
                    break
                j += 1
            toks.append(("str", "\x00" + src[i + 1:j], line))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n
                           and src[i + 1].isdigit()):
            j = i + 1
            while j < n:
                ch = src[j]
                if ch.isalnum() or ch in "._'":
                    j += 1
                    continue
                if ch in "+-" and src[j - 1] in "eEpP":
                    j += 1
                    continue
                break
            toks.append(("num", src[i:j], line))
            i = j
            continue
        if src[i:i + 3] in _CC_PUNCT3:
            toks.append(("punct", src[i:i + 3], line))
            i += 3
            continue
        if src[i:i + 2] in _CC_PUNCT2:
            toks.append(("punct", src[i:i + 2], line))
            i += 2
            continue
        toks.append(("punct", c, line))
        i += 1
    return toks


def cc_str_text(tok: Tuple[str, str, int]) -> str:
    """The content of a ``str`` token (strips the anti-collision
    sentinel)."""

    return tok[1][1:] if tok[0] == "str" else tok[1]


@dataclass
class CcMember:
    name: str
    line: int
    atomic: bool


@dataclass
class CcStruct:
    name: str
    rel: str
    line: int
    members: List[CcMember] = dc_field(default_factory=list)


@dataclass
class CcFunc:
    qname: str                     # "rel/path.cc::Scope::name"
    rel: str
    name: str
    line: int
    sig_lines: Tuple[int, ...]     # signature span, for pragmas
    lo: int                        # body token range [lo, hi)
    hi: int
    #: lexical call sites: (callee last-name, line, token index)
    calls: List[Tuple[str, int, int]] = dc_field(default_factory=list)


@dataclass
class CcFile:
    rel: str
    toks: List[Tuple[str, str, int]]
    supp: Suppressions
    funcs: List[CcFunc] = dc_field(default_factory=list)
    structs: List[CcStruct] = dc_field(default_factory=list)


@dataclass
class CcIndex:
    repo: str
    files: List[CcFile] = dc_field(default_factory=list)
    funcs: Dict[str, CcFunc] = dc_field(default_factory=dict)
    #: last-name -> [qname, ...] (conservative dispatch, like the
    #: Python graph's methods_by_name)
    by_name: Dict[str, List[str]] = dc_field(default_factory=dict)


def iter_native_files(repo: str) -> Iterator[str]:
    base = os.path.join(repo, NATIVE_DIR)
    if not os.path.isdir(base):
        return
    for root, dirs, files in os.walk(base):
        dirs[:] = sorted(d for d in dirs if d != "build")
        for name in sorted(files):
            if name.endswith(_CC_EXTS):
                rel = os.path.relpath(os.path.join(root, name), repo)
                yield rel.replace(os.sep, "/")


#: std/container method names excluded from call edges — they would
#: connect the native graph to noise (the Python graph keeps the same
#: kind of stoplist for builtin container methods); their effects are
#: recognized lexically instead
_CC_EDGE_STOP = frozenset("""
    begin end rbegin rend size empty clear push_back pop_back emplace
    emplace_back push_front pop_front insert erase find count at front
    back data c_str str substr append assign reserve resize swap get
    reset release load store exchange fetch_add fetch_sub fetch_or
    fetch_and compare_exchange_weak compare_exchange_strong lock
    unlock try_lock notify_all notify_one wait wait_for wait_until
    join joinable detach first second length rfind find_first_of
    find_last_of find_first_not_of make_pair make_tuple move forward
    min max abs to_string emplace_front lower_bound upper_bound
    memcpy memmove memset memcmp strlen strcmp strncmp snprintf
    sprintf printf fprintf static_cast reinterpret_cast const_cast
    dynamic_cast
    """.split())

_CC_FN_QUALIFIERS = frozenset({"const", "noexcept", "override",
                               "final", "volatile", "throw", "mutable",
                               "&", "&&"})


def _cc_skip_group(toks: List[Tuple[str, str, int]], i: int,
                   open_t: str, close_t: str) -> int:
    """Index just past the group whose opener is at ``i``; ``len(toks)``
    if unbalanced."""

    d = 0
    n = len(toks)
    while i < n:
        t = toks[i][1]
        if t == open_t:
            d += 1
        elif t == close_t:
            d -= 1
            if d == 0:
                return i + 1
        i += 1
    return n


def _cc_skip_angles(toks: List[Tuple[str, str, int]], i: int) -> int:
    """Skip a balanced ``<...>`` group starting at ``i`` (``>>`` closes
    two); returns index past it, or ``i`` if it does not open one."""

    n = len(toks)
    if i >= n or toks[i][1] != "<":
        return i
    d = 0
    while i < n:
        t = toks[i][1]
        if t == "<":
            d += 1
        elif t == ">":
            d -= 1
        elif t == ">>":
            d -= 2
        elif t in ("(", "{", "["):
            i = _cc_skip_group(toks, i, t,
                               {"(": ")", "{": "}", "[": "]"}[t]) - 1
        elif t == ";":
            return i            # gave up: a stray comparison
        if d <= 0:
            return i + 1
        i += 1
    return n


def _cc_try_function(toks: List[Tuple[str, str, int]],
                     i: int) -> Optional[Tuple[List[str], int, int, int]]:
    """If the identifier at ``i`` starts a function DEFINITION, return
    ``(name_parts, body_lo, body_hi, body_open_idx)`` with the body
    token range [lo, hi) excluding the braces; else None."""

    n = len(toks)
    parts = [toks[i][1]]
    j = i + 1
    while (j + 1 < n and toks[j][1] == "::"
           and toks[j + 1][0] == "id"):
        parts.append(toks[j + 1][1])
        j += 2
    if parts[-1] in _CC_KEYWORDS:
        return None
    if i > 0 and toks[i - 1][1] in (".", "->", "::"):
        return None
    # tolerate one template-argument group on the last name segment
    # (Foo<Bar>::baz was consumed above only without the <Bar>)
    if not (j < n and toks[j][1] == "("):
        return None
    k = _cc_skip_group(toks, j, "(", ")")
    if k >= n:
        return None
    # trailing qualifiers (const, noexcept[(...)], override, ...)
    while k < n:
        t = toks[k][1]
        if t in _CC_FN_QUALIFIERS:
            k += 1
            if k < n and toks[k][1] == "(":
                k = _cc_skip_group(toks, k, "(", ")")
            continue
        break
    if k < n and toks[k][1] == ":":
        # constructor initializer list: comma-separated
        # name(args) / name{args} groups, then the body brace
        k += 1
        while k < n and toks[k][1] != "{":
            t = toks[k][1]
            if t in (";", ")", "}"):
                return None
            if t == "(":
                k = _cc_skip_group(toks, k, "(", ")")
                continue
            k += 1
    if not (k < n and toks[k][1] == "{"):
        return None
    hi = _cc_skip_group(toks, k, "{", "}")
    return parts, k + 1, hi - 1, k


def _cc_members_from_stmt(
        stmt: List[Tuple[str, str, int]]) -> List[CcMember]:
    """Data members declared by one struct-scope statement (already
    stripped of nested ``(...)``/``{...}`` groups, replaced by ``()``
    and ``{}`` markers)."""

    if not stmt:
        return []
    texts = [t for _, t, _ in stmt]
    if "()" in texts:              # method decl / ctor — not data
        return []
    if stmt[0][1] in ("struct", "class", "enum", "union", "using",
                      "typedef", "friend", "static_assert", "template",
                      "public", "private", "protected", "operator"):
        return []
    if "static" in texts:          # class-level constant, not a word
        return []
    atomic = "atomic" in texts
    out: List[CcMember] = []
    # split into declarators on angle-depth-0 commas
    segs: List[List[Tuple[str, str, int]]] = [[]]
    depth = 0
    for tok in stmt:
        t = tok[1]
        if t == "<":
            depth += 1
        elif t == ">":
            depth = max(0, depth - 1)
        elif t == ">>":
            depth = max(0, depth - 2)
        elif t == "," and depth == 0:
            segs.append([])
            continue
        segs[-1].append(tok)
    for seg in segs:
        cut = len(seg)
        for x, tok in enumerate(seg):
            if tok[1] in ("=", "{}"):
                cut = x
                break
        name_tok = None
        for tok in reversed(seg[:cut]):
            if tok[0] == "id" and tok[1] not in _CC_KEYWORDS:
                name_tok = tok
                break
        if name_tok is not None:
            out.append(CcMember(name_tok[1], name_tok[2], atomic))
    return out


def _cc_scan_members(toks: List[Tuple[str, str, int]], lo: int,
                     hi: int) -> List[CcMember]:
    members: List[CcMember] = []
    stmt: List[Tuple[str, str, int]] = []
    i = lo
    while i < hi:
        k, t, ln = toks[i]
        if t == "{":
            i = min(_cc_skip_group(toks, i, "{", "}"), hi)
            if any(x[1] == "()" for x in stmt):
                stmt = []          # a method body just closed
            else:
                stmt.append(("punct", "{}", ln))
            continue
        if t == "(":
            i = min(_cc_skip_group(toks, i, "(", ")"), hi)
            stmt.append(("punct", "()", ln))
            continue
        if t == ";":
            members.extend(_cc_members_from_stmt(stmt))
            stmt = []
            i += 1
            continue
        stmt.append((k, t, ln))
        i += 1
    return members


def _cc_parse_file(rel: str, src: str) -> CcFile:
    toks = cc_lex(src)
    out = CcFile(rel=rel, toks=toks, supp=Suppressions(src))
    n = len(toks)
    depth = 0
    #: (name, depth inside the scope) for namespace/class scopes
    scope: List[Tuple[str, int]] = []
    struct_opens: List[Tuple[str, int, int]] = []  # (name, line, open idx)
    i = 0
    while i < n:
        k, t, ln = toks[i]
        if t == "{":
            depth += 1
            i += 1
            continue
        if t == "}":
            depth -= 1
            while scope and scope[-1][1] > depth:
                scope.pop()
            i += 1
            continue
        if t == "template":
            i = _cc_skip_angles(toks, i + 1)
            continue
        if t in ("namespace", "class", "struct", "union", "enum"):
            j = i + 1
            if t == "enum" and j < n and toks[j][1] in ("class",
                                                        "struct"):
                j += 1
            name = None
            if j < n and toks[j][0] == "id" \
                    and toks[j][1] not in _CC_KEYWORDS:
                name = toks[j][1]
                j += 1
            d_par = 0
            while j < n:
                tj = toks[j][1]
                if tj == "(":
                    d_par += 1
                elif tj == ")":
                    d_par -= 1
                elif d_par == 0 and tj in (";", "{", "="):
                    break
                j += 1
            if j < n and toks[j][1] == "{":
                scope.append((name or "<anon>", depth + 1))
                if t in ("class", "struct") and name is not None:
                    struct_opens.append((name, toks[j][2], j))
                depth += 1
                i = j + 1
                continue
            i = j + 1 if j < n else n
            continue
        if k == "id" and t not in _CC_KEYWORDS:
            got = _cc_try_function(toks, i)
            if got is not None:
                parts, lo, hi, open_idx = got
                scope_names = [s for s, _ in scope]
                qname = "::".join([rel] + scope_names + parts)
                base = qname
                serial = 2
                while qname in {f.qname for f in out.funcs}:
                    qname = f"{base}#{serial}"   # ctor/dtor twins
                    serial += 1
                fn = CcFunc(
                    qname=qname, rel=rel, name=parts[-1], line=ln,
                    sig_lines=tuple(range(ln, toks[open_idx][2] + 1)),
                    lo=lo, hi=hi)
                for m in range(lo, hi):
                    if (toks[m][0] == "id"
                            and toks[m][1] not in _CC_KEYWORDS
                            and toks[m][1] not in _CC_EDGE_STOP
                            and m + 1 < hi and toks[m + 1][1] == "("):
                        fn.calls.append((toks[m][1], toks[m][2], m))
                out.funcs.append(fn)
                i = hi + 1
                continue
        i += 1
    for name, s_ln, open_idx in struct_opens:
        close = _cc_skip_group(toks, open_idx, "{", "}")
        st = CcStruct(name=name, rel=rel, line=s_ln)
        st.members = _cc_scan_members(toks, open_idx + 1, close - 1)
        out.structs.append(st)
    return out


_NATIVE_INDEX_CACHE: Dict[str, Tuple[Tuple[Tuple[str, float, int], ...],
                                     CcIndex]] = {}


def build_native_index(repo: str) -> CcIndex:
    """Lex + index every C++ file under ``tpumon_torch/native/`` (cached per repo on
    file mtimes/sizes — the tests run the analyzer many times)."""

    rels = list(iter_native_files(repo))
    sig: List[Tuple[str, float, int]] = []
    for rel in rels:
        try:
            stx = os.stat(os.path.join(repo, rel))
            sig.append((rel, stx.st_mtime, stx.st_size))
        except OSError:
            sig.append((rel, 0.0, -1))
    key = os.path.abspath(repo)
    cached = _NATIVE_INDEX_CACHE.get(key)
    if cached is not None and cached[0] == tuple(sig):
        return cached[1]
    idx = CcIndex(repo=repo)
    for rel in rels:
        try:
            with open(os.path.join(repo, rel), encoding="utf-8",
                      errors="replace") as fh:
                src = fh.read()
        except OSError:
            continue
        cf = _cc_parse_file(rel, src)
        idx.files.append(cf)
        for fn in cf.funcs:
            idx.funcs[fn.qname] = fn
            idx.by_name.setdefault(fn.name, []).append(fn.qname)
    _NATIVE_INDEX_CACHE[key] = (tuple(sig), idx)
    return idx


def _cc_sup_lines(fn: CcFunc, *lines: int) -> Tuple[int, ...]:
    """Lines where a pragma suppresses a native finding: the finding
    line itself, the line ABOVE it (the C++ comment-above idiom — the
    pragma reasons are long), and the function signature span."""

    above = tuple(ln - 1 for ln in lines if ln > 1)
    return tuple(lines) + above + fn.sig_lines


# -- pass 7a: gil-discipline ---------------------------------------------------

_PY_API_RE = re.compile(r"^_?Py[A-Z_]")
_GIL_MACROS = frozenset({"Py_BEGIN_ALLOW_THREADS",
                         "Py_END_ALLOW_THREADS",
                         "Py_BLOCK_THREADS", "Py_UNBLOCK_THREADS"})
_PY_OBJ_MEMBERS = frozenset({"ob_refcnt", "ob_type", "ob_base",
                             "ob_size", "tp_name", "tp_dealloc"})


def _cc_py_witness(idx: CcIndex) -> Dict[str, str]:
    """qname -> a witness CPython API for every function that touches
    the CPython API directly or transitively (the fixpoint the
    gil-discipline region check consults)."""

    witness: Dict[str, str] = {}
    for q, fn in idx.funcs.items():
        toks = _cc_file_toks(idx, fn.rel)
        for m in range(fn.lo, fn.hi):
            k, t, _ = toks[m]
            if k != "id":
                continue
            if (_PY_API_RE.match(t) and t not in _GIL_MACROS
                    and m + 1 < fn.hi and toks[m + 1][1] == "("):
                witness[q] = t
                break
            if (t in _PY_OBJ_MEMBERS and m > fn.lo
                    and toks[m - 1][1] in (".", "->")):
                witness[q] = f"{t} member access"
                break
    changed = True
    while changed:
        changed = False
        for q, fn in idx.funcs.items():
            if q in witness:
                continue
            for name, _, _ in fn.calls:
                hit = None
                for cq in idx.by_name.get(name, ()):
                    if cq in witness:
                        hit = f"{name} -> {witness[cq]}"
                        break
                if hit is not None:
                    witness[q] = hit
                    changed = True
                    break
    return witness


def _cc_file_toks(idx: CcIndex, rel: str) -> List[Tuple[str, str, int]]:
    for cf in idx.files:
        if cf.rel == rel:
            return cf.toks
    return []


def _cc_file_supp(idx: CcIndex, rel: str) -> Optional[Suppressions]:
    for cf in idx.files:
        if cf.rel == rel:
            return cf.supp
    return None


def check_gil_discipline(idx: CcIndex, *,
                         ignore_suppressions: bool = False
                         ) -> List[Finding]:
    out: List[Finding] = []
    witness = _cc_py_witness(idx)
    for cf in idx.files:
        toks = cf.toks
        supp = None if ignore_suppressions else cf.supp
        for fn in cf.funcs:
            if not any(toks[m][1] in ("Py_BEGIN_ALLOW_THREADS",
                                      "Py_END_ALLOW_THREADS")
                       for m in range(fn.lo, fn.hi)):
                continue
            depth = 0
            stack: List[Tuple[int, int, int]] = []  # (idx, depth, line)
            regions: List[Tuple[int, int]] = []

            def _emit(rule: str, line: int, msg: str) -> None:
                if supp is not None and supp.suppressed(
                        rule, None, *_cc_sup_lines(fn, line)):
                    return
                out.append(Finding(cf.rel, line, rule, msg))

            for m in range(fn.lo, fn.hi):
                t = toks[m][1]
                ln = toks[m][2]
                if t == "{":
                    depth += 1
                elif t == "}":
                    depth -= 1
                elif t == "Py_BEGIN_ALLOW_THREADS":
                    stack.append((m, depth, ln))
                elif t == "Py_END_ALLOW_THREADS":
                    if not stack:
                        _emit("gil-region-unbalanced", ln,
                              "Py_END_ALLOW_THREADS without a matching "
                              "Py_BEGIN_ALLOW_THREADS in "
                              f"{fn.name}() — the region cannot "
                              "balance")
                        continue
                    b_idx, b_depth, b_ln = stack.pop()
                    if b_depth != depth:
                        _emit("gil-region-unbalanced", b_ln,
                              "Py_BEGIN_ALLOW_THREADS (line "
                              f"{b_ln}) and its END (line {ln}) sit "
                              "at different brace depths in "
                              f"{fn.name}() — one path through the "
                              "region skips the reacquire")
                    else:
                        regions.append((b_idx + 1, m))
                elif t in ("return", "goto", "throw") and stack:
                    _emit("gil-region-unbalanced", ln,
                          f"{t} inside a GIL-released region of "
                          f"{fn.name}() (Py_BEGIN at line "
                          f"{stack[-1][2]}) escapes without "
                          "Py_END_ALLOW_THREADS — the thread would "
                          "run on without reacquiring the GIL")
            for _, _, b_ln in stack:
                _emit("gil-region-unbalanced", b_ln,
                      "Py_BEGIN_ALLOW_THREADS in "
                      f"{fn.name}() never reaches a "
                      "Py_END_ALLOW_THREADS")
            for lo, hi in regions:
                for m in range(lo, hi):
                    k, t, ln = toks[m]
                    if k != "id":
                        continue
                    nxt = toks[m + 1][1] if m + 1 < hi else ""
                    prv = toks[m - 1][1] if m > lo else ""
                    if (_PY_API_RE.match(t) and t not in _GIL_MACROS
                            and nxt == "("):
                        _emit("gil-discipline", ln,
                              f"{t}() is called inside a "
                              "Py_BEGIN/END_ALLOW_THREADS region of "
                              f"{fn.name}() — the GIL is not held "
                              "here; move the call outside the "
                              "region")
                        continue
                    if t in _PY_OBJ_MEMBERS and prv in (".", "->"):
                        _emit("gil-discipline", ln,
                              f"PyObject member {t!r} is touched "
                              "inside a GIL-released region of "
                              f"{fn.name}() — object access needs "
                              "the GIL")
                        continue
                    if (nxt == "(" and t not in _CC_KEYWORDS
                            and t not in _CC_EDGE_STOP):
                        for cq in idx.by_name.get(t, ()):
                            if cq in witness and cq != fn.qname:
                                _emit("gil-discipline", ln,
                                      f"{t}() reaches the CPython "
                                      f"API ({witness[cq]}) and is "
                                      "called inside a GIL-released "
                                      f"region of {fn.name}() — "
                                      "hoist the CPython work out "
                                      "of the region")
                                break
    return out


# -- pass 7b: seqlock-discipline -----------------------------------------------

_CC_MEMORY_ORDERS = frozenset({
    "memory_order_relaxed", "memory_order_consume",
    "memory_order_acquire", "memory_order_release",
    "memory_order_acq_rel", "memory_order_seq_cst"})


def _cc_mo_aliases(toks: List[Tuple[str, str, int]], lo: int,
                   hi: int) -> Dict[str, str]:
    """Local ``constexpr auto rx = std::memory_order_relaxed;``-style
    aliases within one body."""

    out: Dict[str, str] = {}
    for m in range(lo, hi - 1):
        if (toks[m][1] == "=" and m > lo and toks[m - 1][0] == "id"):
            for p in range(m + 1, min(m + 4, hi)):
                if toks[p][1] in _CC_MEMORY_ORDERS:
                    out[toks[m - 1][1]] = toks[p][1]
                    break
                if toks[p][1] == ";":
                    break
    return out


def _cc_call_mo(toks: List[Tuple[str, str, int]], open_idx: int,
                aliases: Dict[str, str]) -> str:
    """The memory order named in the call whose ``(`` is at
    ``open_idx`` (default seq_cst when none is written)."""

    end = _cc_skip_group(toks, open_idx, "(", ")")
    for m in range(open_idx + 1, end):
        t = toks[m][1]
        if t in _CC_MEMORY_ORDERS:
            return t
        if toks[m][0] == "id" and t in aliases:
            return aliases[t]
    return "memory_order_seq_cst"


def _cc_seq_sites(toks: List[Tuple[str, str, int]], fn: CcFunc,
                  ops: Tuple[str, ...]
                  ) -> List[Tuple[int, str, int]]:
    """``(token idx, memory order, line)`` for every ``x.seq.<op>()`` /
    ``x->seq.<op>()`` site in the body, in source order."""

    aliases = _cc_mo_aliases(toks, fn.lo, fn.hi)
    sites: List[Tuple[int, str, int]] = []
    for m in range(fn.lo, fn.hi - 3):
        if (toks[m][1] == "seq" and toks[m][0] == "id"
                and m > fn.lo and toks[m - 1][1] in (".", "->")
                and toks[m + 1][1] == "."
                and toks[m + 2][1] in ops
                and toks[m + 3][1] == "("):
            mo = _cc_call_mo(toks, m + 3, aliases)
            sites.append((m, mo, toks[m][2]))
    return sites


def check_seqlock_discipline(idx: CcIndex, *,
                             ignore_suppressions: bool = False
                             ) -> List[Finding]:
    out: List[Finding] = []
    for cf in idx.files:
        toks = cf.toks
        supp = None if ignore_suppressions else cf.supp
        file_bumps = any(
            _cc_seq_sites(toks, fn, ("fetch_add", "store"))
            for fn in cf.funcs)

        def _emit(line: int, msg: str,
                  extra: Tuple[int, ...] = ()) -> None:
            if supp is not None and supp.suppressed(
                    "seqlock-discipline", None, line, *extra):
                return
            out.append(Finding(cf.rel, line, "seqlock-discipline", msg))

        for st in cf.structs:
            seq_members = [m for m in st.members if m.name == "seq"]
            if not seq_members:
                continue
            if not (seq_members[0].atomic or file_bumps):
                continue           # a 'seq' that is not a seqlock
            if not seq_members[0].atomic:
                _emit(seq_members[0].line,
                      f"seqlock sequence word 'seq' of {st.name} is "
                      "not std::atomic — the odd/even handoff tears")
            for m in st.members:
                if m.name != "seq" and not m.atomic:
                    _emit(m.line,
                          f"seqlock data word {m.name!r} of "
                          f"{st.name} is not std::atomic — a reader "
                          "racing the writer tears it (load/store "
                          "data words with relaxed atomics inside "
                          "the seq window)")
        for fn in cf.funcs:
            bumps = _cc_seq_sites(toks, fn, ("fetch_add", "store"))
            loads = _cc_seq_sites(toks, fn, ("load",))
            if len(bumps) >= 2:
                first_mo, last_mo = bumps[0][1], bumps[-1][1]
                if first_mo in ("memory_order_relaxed",
                                "memory_order_consume"):
                    _emit(bumps[0][2],
                          f"seqlock writer {fn.name}() enters the "
                          "odd state with relaxed ordering — the "
                          "mutations may be ordered before the odd "
                          "mark (use memory_order_acq_rel)",
                          fn.sig_lines)
                if last_mo not in ("memory_order_release",
                                   "memory_order_acq_rel",
                                   "memory_order_seq_cst"):
                    _emit(bumps[-1][2],
                          f"seqlock writer {fn.name}() publishes the "
                          "even state without release ordering — "
                          "readers can observe the even seq before "
                          "the data stores (use "
                          "memory_order_release)",
                          fn.sig_lines)
            if len(loads) >= 2:
                first_mo, last_mo = loads[0][1], loads[-1][1]
                if first_mo not in ("memory_order_acquire",
                                    "memory_order_acq_rel",
                                    "memory_order_seq_cst"):
                    _emit(loads[0][2],
                          f"seqlock reader {fn.name}() takes the "
                          "first seq load without acquire ordering "
                          "— the data reads may be hoisted above it "
                          "(use memory_order_acquire)",
                          fn.sig_lines)
                if last_mo in ("memory_order_relaxed",
                               "memory_order_consume"):
                    fenced = any(
                        toks[m][1] == "atomic_thread_fence"
                        and m + 1 < fn.hi and toks[m + 1][1] == "("
                        and _cc_call_mo(toks, m + 1, {}) in
                        ("memory_order_acquire",
                         "memory_order_seq_cst",
                         "memory_order_acq_rel")
                        for m in range(loads[0][0], loads[-1][0]))
                    if not fenced:
                        _emit(loads[-1][2],
                              f"seqlock reader {fn.name}() rechecks "
                              "seq with a relaxed load and no "
                              "acquire fence before it — the data "
                              "copies may be ordered after the "
                              "recheck (add std::atomic_thread_fence"
                              "(std::memory_order_acquire))",
                              fn.sig_lines)
    return out


# -- pass 7c: native effect budgets --------------------------------------------

#: the native twin of EFFECT_BUDGETS: rel-path::Scope::name roots
#: (matched by suffix, so enclosing namespaces need not be spelled),
#: with the effect kinds the root's closure may never perform.  Add a
#: root here when a new native hot path lands (tpumon_torch/docs/static_analysis.md).
NATIVE_EFFECT_BUDGETS: Dict[str, Dict[str, Sequence[str]]] = {
    # the 50-100 Hz burst fold: two seq bumps + relaxed folds per
    # sample, nothing else — the native twin of 'burst-fold'
    "native-burst-fold": {
        "roots": ["tpumon_torch/native/agent/sampler.hpp"
                  "::BurstSampler::fold_cell"],
        "forbid": ("alloc", "lock", "blocking"),
    },
    # gpu-hostengine's SweepDelta encode: per sweep per connection on
    # the serve thread, reading the NVML source (nvml_source.hpp) —
    # allocation is bounded by the reused frame string, but a lock or a
    # blocking call stalls every connected poller
    "native-sweep-encode": {
        "roots": ["tpumon_torch/native/agent/main.cc::Server::sweep_frame"],
        "forbid": ("lock", "blocking"),
    },
    # gpu-hostengine's per-connection sweep serve path (binary + JSON
    # dispatch) down through the NVML source's reads
    "native-sweep-serve": {
        "roots": ["tpumon_torch/native/agent/main.cc"
                  "::Server::sweep_frame_bin",
                  "tpumon_torch/native/agent/main.cc"
                  "::Server::sweep_frame_json"],
        "forbid": ("lock", "blocking"),
    },
    # the codec extension's steady paths (_tpumon_torch_codec): the
    # encode and apply run per sweep per connection and the fold per
    # burst sample, all with the GIL released — a lock or a blocking
    # call would serialize every plane that shares the codec
    "native-codec-steady": {
        "roots": ["tpumon_torch/native/codec/core.hpp::EncoderCore::encode",
                  "tpumon_torch/native/codec/core.hpp::DecoderCore::apply",
                  "tpumon_torch/native/codec/core.hpp::BurstCore::fold",
                  "tpumon_torch/native/codec/core.hpp"
                  "::BurstCore::fold_series"],
        "forbid": ("lock", "blocking"),
    },
    # the poll engine's steady dispatch shell: one epoll readiness
    # event on an established connection — flush, read, scan for one
    # complete message.  At 100k hosts this runs millions of times per
    # tick, so it may never allocate or lock; buffer growth and message
    # processing are routed back to the unbudgeted caller via Act
    # codes.  recv/send stay allowed: the sockets are non-blocking by
    # construction.
    "native-poll-dispatch": {
        "roots": ["tpumon_torch/native/poll/engine.hpp::Engine::dispatch",
                  "tpumon_torch/native/poll/engine.hpp::Engine::scan"],
        "forbid": ("alloc", "lock"),
    },
}

NATIVE_EFFECT_KINDS = ("alloc", "lock", "blocking")

_CC_LOCK_TYPES = frozenset({"lock_guard", "unique_lock",
                            "scoped_lock", "shared_lock"})
_CC_LOCK_CALLS = frozenset({"pthread_mutex_lock", "pthread_mutex_trylock",
                            "pthread_rwlock_rdlock",
                            "pthread_rwlock_wrlock", "flock"})
_CC_BLOCKING_CALLS = frozenset({
    "usleep", "sleep", "nanosleep", "clock_nanosleep", "poll", "ppoll",
    "select", "pselect", "epoll_wait", "epoll_pwait", "accept",
    "accept4", "recv", "recvfrom", "recvmsg", "send", "sendto",
    "sendmsg", "connect", "fsync", "fdatasync", "sleep_for",
    "sleep_until", "waitpid", "sendfile", "getaddrinfo", "system",
    "popen"})
_CC_ALLOC_CALLS = frozenset({"malloc", "calloc", "realloc", "strdup",
                             "make_unique", "make_shared"})
#: allocating container/string methods (recognized lexically; they are
#: edge-stoplisted, so the effect must be read off the token stream)
_CC_ALLOC_METHODS = frozenset({"push_back", "emplace_back", "emplace",
                               "push_front", "emplace_front", "insert",
                               "append", "assign", "resize", "reserve",
                               "to_string", "substr"})


def _cc_fn_effects(toks: List[Tuple[str, str, int]], fn: CcFunc
                   ) -> Dict[str, List[Tuple[int, str]]]:
    """kind -> [(line, what), ...] effects performed lexically by one
    native function body."""

    eff: Dict[str, List[Tuple[int, str]]] = {
        "alloc": [], "lock": [], "blocking": []}
    for m in range(fn.lo, fn.hi):
        k, t, ln = toks[m]
        if k != "id":
            continue
        nxt = toks[m + 1][1] if m + 1 < fn.hi else ""
        prv = toks[m - 1][1] if m > fn.lo else ""
        if t == "new":
            eff["alloc"].append((ln, "operator new"))
        elif t in _CC_LOCK_TYPES:
            eff["lock"].append((ln, f"std::{t} acquisition"))
        elif nxt == "(":
            if t == "lock" and prv in (".", "->"):
                eff["lock"].append((ln, ".lock() call"))
            elif t in _CC_LOCK_CALLS:
                eff["lock"].append((ln, f"{t}() call"))
            elif t in _CC_BLOCKING_CALLS:
                eff["blocking"].append((ln, f"{t}() call"))
            elif t in _CC_ALLOC_CALLS:
                eff["alloc"].append((ln, f"{t}() call"))
            elif t in _CC_ALLOC_METHODS and prv in (".", "->"):
                eff["alloc"].append((ln, f".{t}() call"))
            elif t in ("read", "write", "pread", "pwrite") \
                    and prv == "::":
                eff["blocking"].append((ln, f"::{t}() call"))
    return eff


def _cc_resolve_root(idx: CcIndex, root: str) -> List[str]:
    """A NATIVE_EFFECT_BUDGETS root, matched exactly or by
    ``::``-suffix within the named file (namespaces need not be
    spelled)."""

    if root in idx.funcs:
        return [root]
    rel, _, path = root.partition("::")
    return [q for q, fn in idx.funcs.items()
            if fn.rel == rel and (q == root
                                  or q.endswith("::" + path))]


def check_native_effects(idx: CcIndex, *,
                         budgets: Optional[Dict[str, Dict[str,
                                                          Sequence[str]]]]
                         = None,
                         ignore_suppressions: bool = False
                         ) -> List[Finding]:
    out: List[Finding] = []
    budgets = budgets if budgets is not None else NATIVE_EFFECT_BUDGETS
    indexed_rels = frozenset(cf.rel for cf in idx.files)
    for bname in sorted(budgets):
        spec = budgets[bname]
        forbid = tuple(spec.get("forbid", ()))
        roots: List[str] = []
        for root in spec.get("roots", ()):
            hit = _cc_resolve_root(idx, root)
            if not hit:
                # a root in a file the checkout doesn't have is a
                # budget that doesn't apply (fixtures, partial trees);
                # a root whose FILE is indexed but whose function is
                # gone is a rename that broke the manifest — loud
                if root.partition("::")[0] in indexed_rels:
                    out.append(Finding(
                        MANIFEST_FILE, 0,
                        "native-effect-root-missing",
                        f"NATIVE_EFFECT_BUDGETS[{bname!r}] root "
                        f"{root!r} does not resolve to a function in "
                        f"the native index — fix the manifest or the "
                        f"rename that broke it"))
                continue
            roots.extend(hit)
        # BFS the name-resolved closure, remembering one witness path
        via: Dict[str, str] = {}
        work: List[str] = []
        for q in roots:
            if q not in via:
                via[q] = idx.funcs[q].name
                work.append(q)
        while work:
            q = work.pop()
            fn = idx.funcs[q]
            for name, _, _ in fn.calls:
                for cq in idx.by_name.get(name, ()):
                    if cq not in via:
                        via[cq] = f"{via[q]} -> {name}"
                        work.append(cq)
        seen: Set[Tuple[str, int, str, str]] = set()
        for q in sorted(via):
            fn = idx.funcs[q]
            toks = _cc_file_toks(idx, fn.rel)
            supp = (None if ignore_suppressions
                    else _cc_file_supp(idx, fn.rel))
            eff = _cc_fn_effects(toks, fn)
            for kind in forbid:
                for line, what in eff.get(kind, ()):
                    key = (fn.rel, line, kind, bname)
                    if key in seen:
                        continue
                    if supp is not None and supp.suppressed(
                            "native-effect-budget", None,
                            *_cc_sup_lines(fn, line)):
                        continue
                    seen.add(key)
                    out.append(Finding(
                        fn.rel, line, "native-effect-budget",
                        f"{what} violates the {bname!r} no-{kind} "
                        f"budget (reachable via {via[q]}) — the "
                        f"native hot path declares it never performs "
                        f"this effect; move it off the hot path or "
                        f"suppress with "
                        f"'// tpumon: effect-ok(reason)'"))
    return out


# -- pass 7d: raii-lifetime ----------------------------------------------------

_CC_ACQ_FNS = frozenset({"socket", "accept", "accept4", "open",
                         "openat", "creat", "dup", "dup2", "dup3",
                         "epoll_create", "epoll_create1", "eventfd",
                         "timerfd_create", "signalfd", "inotify_init",
                         "inotify_init1", "memfd_create", "fopen",
                         "fdopen", "opendir"})
_CC_CLOSE_FNS = frozenset({"close", "fclose", "closedir", "pclose"})
#: calls that USE an fd without ever taking ownership of it — passing
#: the fd to one of these is not a handoff, so a later bail-out still
#: owes the close
_CC_NONOWNING_FNS = frozenset({
    "read", "write", "pread", "pwrite", "readv", "writev", "recv",
    "recvfrom", "recvmsg", "send", "sendto", "sendmsg", "fcntl",
    "ioctl", "lseek", "fstat", "ftruncate", "fsync", "fdatasync",
    "setsockopt", "getsockopt", "getsockname", "getpeername",
    "listen", "bind", "shutdown", "printf", "fprintf", "dprintf",
    "snprintf", "perror"})


def _cc_failure_guards(toks: List[Tuple[str, str, int]], lo: int,
                       hi: int, var: str) -> List[Tuple[int, int]]:
    """Token extents of ``if (<failure test of var>) ...`` statements
    — returns inside them bail on an acquisition that FAILED, so no
    release is owed there."""

    spans: List[Tuple[int, int]] = []
    m = lo
    while m < hi:
        if toks[m][1] != "if":
            m += 1
            continue
        if m + 1 >= hi or toks[m + 1][1] != "(":
            m += 1
            continue
        cend = _cc_skip_group(toks, m + 1, "(", ")")
        cond = toks[m + 2:cend - 1]
        texts = [t for _, t, _ in cond]
        has_var = var in texts
        neg = False
        if has_var:
            vi = texts.index(var)
            if vi > 0 and texts[vi - 1] == "!":
                neg = True
            if "<" in texts or "<=" in texts:
                neg = True
            if "==" in texts and ("-" in texts or "nullptr" in texts
                                  or "NULL" in texts):
                neg = True
        if not neg:
            m = cend
            continue
        if cend < hi and toks[cend][1] == "{":
            bend = _cc_skip_group(toks, cend, "{", "}")
        else:
            bend = cend
            while bend < hi and toks[bend][1] != ";":
                bend += 1
            bend += 1
        spans.append((cend, min(bend, hi)))
        m = cend
    return spans


def _cc_is_handoff(toks: List[Tuple[str, str, int]], m: int,
                   lo: int) -> bool:
    """Does the ``var`` occurrence at ``m`` pass ownership on — an
    argument to some call, a lambda capture, a store, a return?"""

    prv = toks[m - 1][1] if m > lo else ""
    if prv in ("return", "="):
        return True
    if prv not in ("(", ","):
        return False
    # walk back to the unmatched opener of this argument list
    d_par = d_brk = 0
    p = m - 1
    while p >= lo:
        t = toks[p][1]
        if t == ")":
            d_par += 1
        elif t == "(":
            if d_par == 0:
                before = toks[p - 1] if p - 1 >= lo else ("punct", "", 0)
                return (before[0] == "id"
                        and before[1] not in _CC_KEYWORDS
                        and before[1] not in _CC_NONOWNING_FNS)
            d_par -= 1
        elif t == "]":
            d_brk += 1
        elif t == "[":
            if d_brk == 0 and d_par == 0:
                return True        # lambda capture list
            d_brk -= 1
        elif t == ";":
            return False
        p -= 1
    return False


def check_raii_lifetime(idx: CcIndex, *,
                        ignore_suppressions: bool = False
                        ) -> List[Finding]:
    out: List[Finding] = []
    for cf in idx.files:
        if cf.rel.startswith(NATIVE_DIR + "/testlib/"):
            continue               # test mains exit; the OS reaps them
        toks = cf.toks
        supp = None if ignore_suppressions else cf.supp
        for fn in cf.funcs:
            m = fn.lo
            while m < fn.hi:
                k, t, _ = toks[m]
                if not (k == "id" and m + 1 < fn.hi
                        and toks[m + 1][1] == "="):
                    m += 1
                    continue
                if m > fn.lo and toks[m - 1][1] in (".", "->"):
                    # self->member = acquire(): ownership lands in the
                    # object right away — its dtor/close owns release
                    m += 1
                    continue
                j = m + 2
                if j < fn.hi and toks[j][1] == "::":
                    j += 1
                is_new = j < fn.hi and toks[j][1] == "new"
                is_acq = (j + 1 < fn.hi and toks[j][0] == "id"
                          and toks[j][1] in _CC_ACQ_FNS
                          and toks[j + 1][1] == "(")
                if not (is_new or is_acq):
                    m += 1
                    continue
                var = t
                acq_line = toks[m][2]
                what = "operator new" if is_new else toks[j][1] + "()"
                # end of the acquisition statement
                s = j
                d = 0
                while s < fn.hi:
                    ts = toks[s][1]
                    if ts == "(":
                        d += 1
                    elif ts == ")":
                        d -= 1
                    elif ts == ";" and d <= 0:
                        break
                    s += 1
                guards = _cc_failure_guards(toks, s, fn.hi, var)
                released = False
                flagged = False
                q = s
                while q < fn.hi:
                    tq = toks[q][1]
                    if toks[q][0] == "id" and tq == var:
                        prv = toks[q - 1][1]
                        if prv == "(" and q - 2 >= s \
                                and toks[q - 2][1] in _CC_CLOSE_FNS:
                            released = True
                        elif prv == "delete" or (
                                prv == "]" and q - 3 >= s
                                and toks[q - 3][1] == "delete"):
                            released = True
                        elif _cc_is_handoff(toks, q, s):
                            released = True
                        elif toks[q + 1][1] == "=" if q + 1 < fn.hi \
                                else False:
                            released = True   # reassigned: new value
                    elif tq in ("return", "throw") and not released:
                        nxt = toks[q + 1][1] if q + 1 < fn.hi else ""
                        if nxt == var:
                            released = True
                        elif not any(a <= q < b for a, b in guards):
                            line = toks[q][2]
                            if not (supp is not None
                                    and supp.suppressed(
                                        "raii-lifetime", None,
                                        *_cc_sup_lines(
                                            fn, line, acq_line))):
                                out.append(Finding(
                                    cf.rel, line, "raii-lifetime",
                                    f"{tq} leaks {var!r} ({what} at "
                                    f"line {acq_line}) in "
                                    f"{fn.name}() — close/delete or "
                                    f"hand it off before leaving on "
                                    f"this path"))
                            flagged = True
                            break
                    q += 1
                if not released and not flagged:
                    if not (supp is not None and supp.suppressed(
                            "raii-lifetime", None,
                            *_cc_sup_lines(fn, acq_line))):
                        out.append(Finding(
                            cf.rel, acq_line, "raii-lifetime",
                            f"{var!r} ({what}) acquired in "
                            f"{fn.name}() never reaches "
                            f"close/delete or a handoff — it leaks "
                            f"on every path"))
                m = s + 1
    return out


# -- pass 7e: op-handler table -------------------------------------------------

def cc_op_handler_table(toks: List[Tuple[str, str, int]],
                        declared: FrozenSet[str]
                        ) -> Dict[str, Tuple[Optional[str], int]]:
    """op literal -> (handler function name or None, dispatch line),
    extracted from ``op == "x"`` / ``req["op"].as_str() == "x"``
    comparisons: the handler is the first declared function called in
    the guarded statement or block.  This replaces the regex-literal
    op scan — the table is call-graph-grounded, so pass 4 now knows
    not only WHICH ops the daemon dispatches but WHERE each one
    lands."""

    table: Dict[str, Tuple[Optional[str], int]] = {}
    n = len(toks)
    for m in range(n):
        if toks[m][0] != "str":
            continue
        lit, ln = cc_str_text(toks[m]), toks[m][2]
        op = None
        if (m >= 2 and toks[m - 1][1] == "=="
                and toks[m - 2][0] == "id" and toks[m - 2][1] == "op"):
            op = lit
        elif (m + 2 < n and toks[m + 1][1] == "=="
                and toks[m + 2][0] == "id" and toks[m + 2][1] == "op"):
            op = lit
        elif (m >= 7 and toks[m - 1][1] == "=="
                and toks[m - 2][1] == ")" and toks[m - 3][1] == "("
                and toks[m - 4][1] == "as_str"
                and toks[m - 5][1] == "." and toks[m - 6][1] == "]"
                and toks[m - 7][0] == "str"
                and cc_str_text(toks[m - 7]) == "op"):
            op = lit
        if op is None or not op:
            continue
        j = m + 1
        d = 0
        while j < n:
            tj = toks[j][1]
            if tj == "(":
                d += 1
            elif tj == ")":
                if d == 0:
                    break
                d -= 1
            j += 1
        j += 1
        if j < n and toks[j][1] == "{":
            end = _cc_skip_group(toks, j, "{", "}")
            j += 1
        else:
            end = j
            while end < n and toks[end][1] != ";":
                end += 1
        handler = None
        for q in range(j, end):
            if (toks[q][0] == "id" and toks[q][1] in declared
                    and toks[q][1] not in _CC_KEYWORDS
                    and q + 1 < n and toks[q + 1][1] == "("):
                handler = toks[q][1]
                break
        if op not in table:
            table[op] = (handler, ln)
    return table


def native_op_table(repo: str) -> Dict[str, Optional[str]]:
    """op -> handler name for the daemon dispatch (the ``--json``
    artifact carries it so protocol reviews see the routing)."""

    idx = build_native_index(repo)
    toks = _cc_file_toks(idx, "tpumon_torch/native/agent/main.cc")
    if not toks:
        return {}
    declared = frozenset(idx.by_name)
    return {op: h for op, (h, _) in
            cc_op_handler_table(toks, declared).items()}


# -- pass 7 driver -------------------------------------------------------------

def check_native(repo: str, *,
                 budgets: Optional[Dict[str, Dict[str,
                                                  Sequence[str]]]] = None,
                 ignore_suppressions: bool = False) -> List[Finding]:
    """The native analysis plane: gil-discipline, seqlock-discipline,
    native effect budgets and raii-lifetime over ``tpumon_torch/native/``."""

    idx = build_native_index(repo)
    out: List[Finding] = []
    out += check_gil_discipline(
        idx, ignore_suppressions=ignore_suppressions)
    out += check_seqlock_discipline(
        idx, ignore_suppressions=ignore_suppressions)
    out += check_native_effects(
        idx, budgets=budgets,
        ignore_suppressions=ignore_suppressions)
    out += check_raii_lifetime(
        idx, ignore_suppressions=ignore_suppressions)
    return out


# -- SARIF ---------------------------------------------------------------------

_SARIF_SCHEMA = ("https://docs.oasis-open.org/sarif/sarif/v2.1.0/"
                 "errata01/os/schemas/sarif-schema-2.1.0.json")


def to_sarif(findings: Sequence[Finding]) -> Dict[str, object]:
    """The findings model rendered as SARIF 2.1.0 (same content as
    ``--json``) so CI can annotate PRs from the artifact."""

    rules = [{"id": rid,
              "shortDescription": {"text": desc}}
             for rid, desc in sorted(RULES.items())]
    index = {r["id"]: i for i, r in enumerate(rules)}
    results: List[Dict[str, object]] = []
    for f in findings:
        results.append({
            "ruleId": f.rule,
            "ruleIndex": index.get(f.rule, -1),
            "level": "error",
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": f.path},
                    "region": {"startLine": max(f.line, 1)},
                },
            }],
        })
    return {
        "$schema": _SARIF_SCHEMA,
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "tpumon-check",
                "informationUri":
                    "https://github.com/tpumon/tpumon/blob/main/"
                    "tpumon_torch/docs/static_analysis.md",
                "rules": rules,
            }},
            "results": results,
        }],
    }


# -- driver --------------------------------------------------------------------

def run_repo(repo: str, *,
             manifest: Optional[Dict[str, List[str]]] = None,
             thread_manifest: Optional[Dict[str, List[str]]] = None,
             passes: Optional[Sequence[str]] = None,
             ignore_suppressions: bool = False,
             legacy_scope: bool = True,
             graph: Optional[Graph] = None,
             thread_model: Optional[ThreadModel] = None,
             codec_constants: Optional[Dict[str, float]] = None,
             ) -> List[Finding]:
    passes = tuple(passes) if passes is not None else \
        ("hot", "locks", "threads", "protocol", "lifetime", "effects",
         "native")
    g = graph if graph is not None else build_graph(repo)
    findings = list(g.findings)
    if "hot" in passes:
        findings += check_hot_properties(
            g, manifest if manifest is not None else HOT_ROOTS,
            ignore_suppressions=ignore_suppressions,
            legacy_scope=legacy_scope)
        findings += check_hot_python_codec(
            g, manifest if manifest is not None else HOT_ROOTS,
            ignore_suppressions=ignore_suppressions)
    if "locks" in passes:
        findings += check_locks(
            g, ignore_suppressions=ignore_suppressions)
    if "threads" in passes:
        findings += check_threads(
            g, manifest=thread_manifest,
            ignore_suppressions=ignore_suppressions,
            model=thread_model)
    if "protocol" in passes:
        findings += check_protocol_sync(repo,
                                        codec_constants=codec_constants)
    if "lifetime" in passes:
        findings += check_lifetimes(
            g, manifest=manifest,
            ignore_suppressions=ignore_suppressions)
    if "effects" in passes:
        findings += check_effects(
            g, ignore_suppressions=ignore_suppressions)
    if "native" in passes:
        findings += check_native(
            repo, ignore_suppressions=ignore_suppressions)
    return sorted(set(findings),
                  key=lambda f: (f.path, f.line, f.rule, f.message))


#: the pragma kinds the inventory (and so the baseline) counts
INVENTORY_KINDS = ("thread-ok", "close-ok", "effect-ok", "codec-ok",
                   "check-disable", "lint-disable")


def suppression_inventory(g: Graph) -> List[Dict[str, object]]:
    """Every pragma in the tree with its reason — the mandatory-reason
    kinds (``thread-ok``, ``close-ok``, ``effect-ok``, ``codec-ok``) and
    the ``tpumon-check``/``tpumon-lint`` ``disable=`` pragmas (their
    rule list as the reason) — the auditable other half of a clean run,
    diffed against ``tpumon_torch/tools/check_baseline.json``."""

    out: List[Dict[str, object]] = []
    for rel in sorted(g.modules):
        supp = g.modules[rel].supp
        pragmas = {**supp.reason_pragmas(), **supp.disable_pragmas()}
        for kind in INVENTORY_KINDS:
            for line, reason in sorted(pragmas[kind].items()):
                out.append({"path": rel, "line": line, "kind": kind,
                            "reason": reason})
    # the native plane shares the machinery: C++ pragmas behind //
    # are inventoried (and baselined) exactly like the Python ones
    idx = build_native_index(g.repo)
    for cf in sorted(idx.files, key=lambda c: c.rel):
        pragmas = {**cf.supp.reason_pragmas(), **cf.supp.disable_pragmas()}
        for kind in INVENTORY_KINDS:
            for line, reason in sorted(pragmas[kind].items()):
                out.append({"path": cf.rel, "line": line, "kind": kind,
                            "reason": reason})
    return out


def baseline_diff(findings: Sequence[Finding],
                  suppressions: Sequence[Dict[str, object]],
                  baseline: Dict[str, object]) -> List[str]:
    """Compare the current run against a committed baseline.  Findings
    match on (path, rule); suppressions on (path, kind, reason) — line
    numbers churn on unrelated edits and are deliberately not part of
    the identity (a baseline entry without a ``kind`` is read as
    ``thread-ok``, the only kind that predates the lifetime/effect
    passes).  The match is COUNTED (a multiset): copy-pasting an
    already-blessed pragma onto a second site in the same file, or a
    second instance of a baselined rule, is drift too — otherwise one
    accepted race would bless every future lookalike.  Any drift (new
    finding, resolved finding, new or removed suppression) is
    reported: the baseline is a golden file, updated deliberately in
    the same commit as the change it blesses."""

    diffs: List[str] = []
    base_f = Counter((str(f.get("path")), str(f.get("rule")))
                     for f in baseline.get("findings", ()))  # type: ignore[union-attr]
    cur_f = Counter((f.path, f.rule) for f in findings)
    base_s = Counter((str(s.get("path")),
                      str(s.get("kind", "thread-ok")),
                      str(s.get("reason")))
                     for s in baseline.get("suppressions", ()))  # type: ignore[union-attr]
    cur_s = Counter((str(s["path"]),
                     str(s.get("kind", "thread-ok")),
                     str(s["reason"]))
                    for s in suppressions)

    def _n(n: int) -> str:
        return f" (x{n})" if n > 1 else ""

    for (path, rule), n in sorted((cur_f - base_f).items()):
        diffs.append(f"new finding not in baseline: {path}: "
                     f"{rule}{_n(n)}")
    for (path, rule), n in sorted((base_f - cur_f).items()):
        diffs.append(f"baseline finding no longer present "
                     f"(remove it): {path}: {rule}{_n(n)}")
    for (path, kind, reason), n in sorted((cur_s - base_s).items()):
        diffs.append(f"new {kind} suppression not in baseline: "
                     f"{path}: ({reason}){_n(n)}")
    for (path, kind, reason), n in sorted((base_s - cur_s).items()):
        diffs.append(f"baseline {kind} suppression no longer present "
                     f"(remove it): {path}: ({reason}){_n(n)}")
    return diffs


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="tpumon-check",
        description="whole-program hot-path, lock-order and "
                    "wire-protocol analysis for the port, tpumon_torch "
                    "(see tpumon_torch/docs/static_analysis.md)")
    p.add_argument("--repo", default=None,
                   help="repo root (default: the directory holding "
                        "tpumon_torch/)")
    p.add_argument("--json", default=None, metavar="PATH",
                   help="additionally write machine-readable findings")
    p.add_argument("--sarif", default=None, metavar="PATH",
                   help="additionally write the findings as SARIF "
                        "2.1.0 (same findings model as --json) — the "
                        "CI lint job uploads it so findings annotate "
                        "PRs")
    p.add_argument("--baseline", default=None, metavar="PATH",
                   help="diff findings + thread-ok suppressions "
                        "against a committed baseline JSON; exit "
                        "nonzero on ANY drift (new finding, resolved "
                        "finding, new/removed suppression)")
    p.add_argument("--thread-report", action="store_true",
                   help="print the inferred thread-role and "
                        "guarded-by tables and exit")
    p.add_argument("--list-rules", action="store_true",
                   help="print rule names + descriptions and exit")
    args = p.parse_args(argv)
    if args.list_rules:
        for rule, desc in sorted(RULES.items()):
            print(f"{rule:24s} {desc}")
        return 0
    repo = args.repo or _REPO_ROOT
    t0 = _time.monotonic()
    g = build_graph(repo)
    # one thread model serves the findings pass, --thread-report and
    # the --json guarded-by table (the fixpoints are the analysis cost)
    tm = build_thread_model(g, THREAD_ROOTS)
    if args.thread_report:
        for group in sorted(THREAD_ROOTS):
            for r in THREAD_ROOTS[group]:
                print(f"role {group:10s} root {r}")
        for label, info in thread_guard_table(g, model=tm).items():
            print(f"{label:50s} roles={','.join(info['roles'])} "
                  f"guarded-by={','.join(info['guarded_by']) or '-'}")
        return 0
    findings = run_repo(repo, graph=g, thread_model=tm)
    suppressions = suppression_inventory(g)
    elapsed = _time.monotonic() - t0
    for f in findings:
        print(f.render())
    n = len(findings)
    stats = {
        "files": len(g.modules),
        "functions": len(g.funcs),
        "classes": len(g.classes),
        "edges": g.resolved_edges,
        "fallback_edges": g.fallback_edges,
        "seconds": round(elapsed, 3),
    }
    print(f"tpumon-check: {n} finding{'s' if n != 1 else ''} "
          f"({len(RULES)} rules; {stats['functions']} functions, "
          f"{stats['edges']} edges, {stats['fallback_edges']} "
          f"fallback, {elapsed:.2f}s)")
    if args.json:
        with open(args.json, "w", encoding="utf-8") as jf:
            _json.dump({"findings": [f.as_dict() for f in findings],
                        "suppressions": suppressions,
                        "threads": thread_guard_table(g, model=tm),
                        "raises": raise_report(g),
                        "effects": effect_signature_table(g),
                        "native_ops": native_op_table(repo),
                        "stats": stats}, jf, indent=2)
            jf.write("\n")
    if args.sarif:
        with open(args.sarif, "w", encoding="utf-8") as sf:
            _json.dump(to_sarif(findings), sf, indent=2)
            sf.write("\n")
    rc = 1 if findings else 0
    if args.baseline:
        with open(args.baseline, encoding="utf-8") as bf:
            baseline = _json.load(bf)
        diffs = baseline_diff(findings, suppressions, baseline)
        for d in diffs:
            print(f"tpumon-check: baseline drift: {d}")
        if diffs:
            print(f"tpumon-check: update {args.baseline} in the same "
                  f"commit if this drift is intended")
            rc = 1
        else:
            # no drift: every finding (if any) is baseline-tolerated
            rc = 0
    return rc


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # `tpumon_check | head` is not an error
        sys.exit(0)
