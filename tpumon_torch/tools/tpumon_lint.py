#!/usr/bin/env python3
"""tpumon-lint for the port — repo-aware static analysis of ``tpumon_torch/``.

The port's copy of the JAX package's lexical lint, with the reference's
rule names, pragma syntax and CLI, pointed at ``tpumon_torch/`` and its
native tree.  The native agent and the codec/poll extensions have
TSan/ASan coverage (``tests/test_torch_sanitizers.py``, opt-in); this is
the Python side's backstop.  Two kinds of rule, all stdlib (``ast`` +
regex), no third-party deps:

**AST rules** (per-file, scoped to the paths where the bug class lives):

* ``silent-except`` — a bare ``except:`` anywhere in
  ``tpumon_torch/backends/`` or ``tpumon_torch/exporter/``, or an
  ``except Exception:`` whose body is only ``pass``.  Degradation must
  be *visible* (``tpumon_torch.log.warn_every`` / ``vlog``).
* ``lock-discipline`` — an instance attribute written both inside and
  outside a ``with self._lock:`` block in the same class (``__init__``
  excluded: construction precedes threads).  The threaded
  exporter/watch/agent paths are where unlocked writes become races.
* ``wallclock-in-sampling`` — a ``time.time()`` call in a sampling-path
  module.  Deadlines and intervals must use ``time.monotonic()`` (NTP
  steps must not stretch or collapse sweep timing); wall-clock *sample
  timestamps* are a legitimate API and carry a suppression.
* ``fsync-in-hot-path`` — ``os.fsync``/``os.fdatasync``/``.flush()`` in
  the flight recorder (``tpumon_torch/blackbox.py``).  Segment appends
  run on the sweep thread; the flush policy is time-based and fsync is
  never paid per sweep (the timed-flush site carries a suppression).
* ``encode-in-hot-path``, ``json-in-sweep-path``,
  ``blocking-socket-in-fleetpoll``, ``mutex-in-burst-loop`` and
  ``finally-control-flow`` as described in ``RULES``.

**Cross-artifact rules** (repo-level catalog coherence):

* ``catalog-native-sync`` — every exported family in
  ``tpumon_torch/fields.py`` has a matching row (name/type/help/vector/
  set bitmask) in ``tpumon_torch/native/agent/catalog.inc``, and no
  stale extras.
* ``catalog-doc-sync`` — ``tpumon_torch/docs/metrics.md`` (written by
  ``python -m tpumon_torch.tools.gen_metrics_doc``) documents exactly
  the catalog: one table row per field, matching family/type/set/help.
* ``catalog-set-membership`` — exporter field sets reference only
  catalog fields, never LABEL-type fields, without duplicates, and
  base/profiling/dcn stay pairwise disjoint.
* ``prom-name-style`` — Prometheus family names are ``tpu_``-prefixed
  ``[a-z0-9_]`` and unique; short names unique; ``FieldMeta.field_id``
  matches its catalog key.
* ``entrypoint-resolves`` — the port declares no console scripts; its
  entry points are the ``python -m tpumon_torch.<module>`` commands that
  ``deploy/gpu/`` and ``README.md`` run.  Each must name an existing
  module with a ``__main__`` guard (or a package with ``__main__.py``):
  a broken command otherwise surfaces only at container runtime.

Suppression: append ``# tpumon-lint: disable=rule-a,rule-b`` to the
offending line, or to the ``def`` line of the enclosing function to
suppress within that function (used e.g. where a helper documents that
its caller holds the lock).  Run as ``python -m
tpumon_torch.tools.tpumon_lint``; exits non-zero when findings remain.
See ``tpumon_torch/docs/lint.md``.
"""

from __future__ import annotations

import argparse
import ast
import os
import re
import sys
from dataclasses import dataclass, field as dc_field
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

# -- rule registry -------------------------------------------------------------

RULES: Dict[str, str] = {
    "silent-except": (
        "bare except / except-Exception-pass in backends or exporter: "
        "degradation must log"),
    "lock-discipline": (
        "attribute written both under and outside `with self._lock:` "
        "in the same class"),
    "wallclock-in-sampling": (
        "time.time() in a sampling path where time.monotonic() is "
        "required"),
    "encode-in-hot-path": (
        "str.encode()/str.splitlines() in the exporter sweep path: the "
        "pipeline is bytes-oriented and incremental — full-text "
        "re-encoding/re-parsing per sweep is the regression it exists "
        "to prevent"),
    "json-in-sweep-path": (
        "json.loads()/json.dumps() in the client sweep hot path: the "
        "sweep RPC is binary delta frames (tpumon_torch/sweepframe.py) — "
        "per-sweep JSON round trips are the regression it replaced"),
    "blocking-socket-in-fleetpoll": (
        "blocking socket primitive in the fleet multiplexer: the "
        "poller is ONE thread driving every host — a single blocking "
        "call (settimeout deadline, setblocking(True), makefile, "
        "sendall, accept, time.sleep) stalls the whole slice's sweep; "
        "deadlines come from the loop's monotonic clock"),
    "fsync-in-hot-path": (
        "fsync/fdatasync/flush in the flight-recorder append path: "
        "segment appends run on the sweep thread — the flush policy "
        "is time-based (one buffered flush per interval) and fsync is "
        "never paid per sweep"),
    "mutex-in-burst-loop": (
        "lock/allocation-heavy call in the burst inner-loop fold: the "
        "fold runs 50-100x per second per (chip, field) on a "
        "lock-free single-producer path — a mutex or a per-sample "
        "allocation there is the 100x-CPU regression burst mode's "
        "handoff design exists to prevent"),
    "finally-control-flow": (
        "return/break/continue inside a finally block silently "
        "discards an in-flight exception — the error vanishes exactly "
        "where teardown code runs"),
    "catalog-native-sync": (
        "tpumon_torch/fields.py and tpumon_torch/native/agent/catalog.inc "
        "disagree"),
    "catalog-doc-sync": (
        "tpumon_torch/fields.py and tpumon_torch/docs/metrics.md "
        "disagree"),
    "catalog-set-membership": (
        "exporter field set references a missing/LABEL/duplicate field"),
    "prom-name-style": (
        "prometheus family naming: tpu_ prefix, [a-z0-9_], unique"),
    "entrypoint-resolves": (
        "a `python -m tpumon_torch.<module>` command in deploy/gpu/ or "
        "README.md does not resolve to a runnable module"),
    "parse-error": (
        "file does not parse — every AST rule is moot until it does"),
}

#: the package under analysis, its native tree and the artifacts the
#: cross-artifact rules hold it to (repo-relative, '/'-separated)
PKG = "tpumon_torch"
#: the repo root: the directory that holds ``tpumon_torch/``
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: the analyzers' own subpackage: not part of the system under analysis
#: (the reference's tools sit outside its package walk as well)
TOOLS_DIR = PKG + "/tools"
CATALOG_INC = PKG + "/native/agent/catalog.inc"
METRICS_DOC = PKG + "/docs/metrics.md"
#: where the port's ``python -m`` entry points are written down
ENTRYPOINT_SOURCES = ("README.md", "deploy/gpu")

#: files (relative, '/'-separated) the silent-except rule covers
_SILENT_EXCEPT_SCOPE = ("tpumon_torch/backends/", "tpumon_torch/exporter/")

#: sampling-path scope for wallclock-in-sampling: prefixes and exact files
_SAMPLING_PREFIXES = ("tpumon_torch/backends/", "tpumon_torch/exporter/", "tpumon_torch/cli/")
_SAMPLING_FILES = frozenset({
    "tpumon_torch/trace.py", "tpumon_torch/watch.py", "tpumon_torch/kmsg.py",
    "tpumon_torch/health.py", "tpumon_torch/policy.py", "tpumon_torch/fleetpoll.py",
    "tpumon_torch/blackbox.py", "tpumon_torch/frameserver.py",
    "tpumon_torch/fleetshard.py", "tpumon_torch/burst.py",
    # the detection plane takes `now` as an argument everywhere — a
    # clock call inside it would fork live and backtest timelines,
    # which is the one thing the subsystem must never do
    "tpumon_torch/anomaly.py",
    # the relay's staleness/backoff/breaker clocks must be
    # monotonic — wall time only ever PASSES THROUGH from upstream
    # tick records (the replay-correlation stamps)
    "tpumon_torch/relay.py",
    # restart backoff / staleness clocks must be monotonic, and
    # the chaos timeline is tick arithmetic over a fixed origin — a
    # wall clock in either is the flaky-under-ntp bug this rule exists
    # for
    "tpumon_torch/supervisor.py", "tpumon_torch/chaos.py",
})

#: exporter sweep-path files where per-sweep full-text churn is banned:
#: after the incremental render/merge/serve rework, every .encode() or
#: .splitlines() here must be once-per-change (cached), once-per-publish,
#: or an explicitly-suppressed oracle/fallback path
_HOT_TEXT_FILES = frozenset({
    "tpumon_torch/exporter/exporter.py", "tpumon_torch/exporter/promtext.py",
    "tpumon_torch/frameserver.py", "tpumon_torch/burst.py",
    # the anomaly score path runs per sweep per host: finding
    # emission is edge-gated, but a per-sample encode would not be
    "tpumon_torch/anomaly.py",
    # the relay's steady path forwards upstream bytes VERBATIM — the
    # only text encode is the once-per-connection subscribe op
    "tpumon_torch/relay.py",
})

#: client sweep-path files where per-sweep JSON codec work is banned:
#: after the binary sweep_frame op, every json.loads/json.dumps here is
#: either negotiation (one probe per connection), a non-sweep op, or
#: the JSON differential-oracle fallback — all suppressed with a
#: comment saying which; anything new argues its case the same way
_SWEEP_JSON_FILES = frozenset({
    "tpumon_torch/backends/agent.py", "tpumon_torch/sweepframe.py",
    "tpumon_torch/fleetpoll.py", "tpumon_torch/blackbox.py",
    "tpumon_torch/frameserver.py", "tpumon_torch/fleetshard.py",
    "tpumon_torch/burst.py", "tpumon_torch/anomaly.py",
    # relay: one JSON subscribe op per upstream CONNECTION; the
    # per-tick path is binary records only
    "tpumon_torch/relay.py",
})

#: single-threaded-multiplexer files where blocking socket primitives
#: are banned: the fleet poller and the frame server each run ONE loop
#: thread by design — per-host deadlines and send scheduling come from
#: the loop's monotonic clock, never from per-socket timeouts, and a
#: blocking send in the stream tee would let one slow subscriber stall
#: every other subscriber's fan-out
_FLEETPOLL_FILES = frozenset({"tpumon_torch/fleetpoll.py",
                              "tpumon_torch/frameserver.py",
                              "tpumon_torch/fleetshard.py"})

#: burst-engine files where the inner-loop fold functions (any function
#: whose name starts with ``fold``) must stay lock-free and
#: allocation-light: the fold runs 50-100x/s per (chip, field) on a
#: single producer thread, and the whole perf claim (100x the samples
#: at <=3x the sweep-path CPU) rests on it staying a few local-variable
#: ops per sample
_BURST_FILES = frozenset({"tpumon_torch/burst.py"})

#: function-name prefix that marks a burst inner-loop fold function
_BURST_FOLD_PREFIX = "fold"

#: flight-recorder files where per-sweep durability syscalls are banned:
#: segment appends run on the sweep thread (exporter loop / fleet
#: poller), so fsync-per-append would put disk latency into the sweep
#: cadence — the flush policy is time-based, and the one timed flush
#: site carries a suppression saying so
_BLACKBOX_FILES = frozenset({"tpumon_torch/blackbox.py"})

#: methods whose writes never race (run before any thread sees the object)
_CTOR_METHODS = frozenset({"__init__", "__new__", "__post_init__"})


@dataclass(frozen=True)
class Finding:
    path: str          # repo-relative, '/'-separated
    line: int          # 1-based; 0 for whole-file/artifact findings
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule}: {self.message}"


_DISABLE_RE = re.compile(r"#\s*tpumon-lint:\s*disable=([A-Za-z0-9_,\- ]+)")


class Suppressions:
    """Per-line ``# tpumon-lint: disable=...`` pragmas for one file."""

    def __init__(self, src: str) -> None:
        self._by_line: Dict[int, Set[str]] = {}
        for i, line in enumerate(src.splitlines(), start=1):
            m = _DISABLE_RE.search(line)
            if m:
                self._by_line[i] = {
                    r.strip() for r in m.group(1).split(",") if r.strip()}

    def suppressed(self, rule: str, *lines: int) -> bool:
        """True when any of ``lines`` (the finding's own line plus its
        enclosing ``def`` lines) carries a disable pragma for ``rule``."""

        return any(rule in self._by_line.get(ln, ()) for ln in lines)


# -- AST rules -----------------------------------------------------------------

def _is_lockish(expr: ast.AST) -> bool:
    """True for context managers that look like locks: ``self._lock``,
    ``some_lock``, ``self._lock_for(x)`` — anything whose terminal name
    contains 'lock'."""

    if isinstance(expr, ast.Attribute):
        return "lock" in expr.attr.lower()
    if isinstance(expr, ast.Name):
        return "lock" in expr.id.lower()
    if isinstance(expr, ast.Call):
        return _is_lockish(expr.func)
    return False


def _self_attr_stores(node: ast.stmt) -> Iterator[Tuple[str, int]]:
    """Yield (attr, lineno) for every ``self.X = ...`` style write in one
    statement (Assign/AugAssign/AnnAssign, through tuple unpacking)."""

    targets: List[ast.expr] = []
    if isinstance(node, ast.Assign):
        targets = list(node.targets)
    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        targets = [node.target]
    for t in targets:
        stack = [t]
        while stack:
            e = stack.pop()
            if isinstance(e, (ast.Tuple, ast.List)):
                stack.extend(e.elts)
            elif (isinstance(e, ast.Attribute)
                  and isinstance(e.value, ast.Name)
                  and e.value.id == "self"):
                yield e.attr, node.lineno


def _def_header_lines(fn: ast.AST) -> Tuple[int, ...]:
    """Every line of a def's signature header (``def`` line through the
    line before the first body statement) — a suppression pragma may sit
    on any of them when the signature wraps."""

    first_body = fn.body[0].lineno if getattr(fn, "body", None) \
        else fn.lineno + 1  # type: ignore[attr-defined]
    return tuple(range(fn.lineno, first_body))  # type: ignore[attr-defined]


@dataclass
class _AttrWrite:
    attr: str
    line: int
    locked: bool
    def_lines: Tuple[int, ...]   # enclosing def linenos, for suppression


def _walk_class_writes(cls: ast.ClassDef) -> List[_AttrWrite]:
    """Collect every ``self.X`` write in a class with its lexical lock
    state.  Nested functions inherit the lock state of their definition
    site (a helper called under the lock but defined outside a ``with``
    must carry a def-line suppression)."""

    writes: List[_AttrWrite] = []

    def walk(node: ast.AST, locked: bool, in_ctor: bool,
             def_lines: Tuple[int, ...]) -> None:
        for child in ast.iter_child_nodes(node):
            c_locked, c_ctor, c_defs = locked, in_ctor, def_lines
            if isinstance(child, ast.ClassDef):
                continue  # nested classes are their own scope
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                c_defs = def_lines + _def_header_lines(child)
                if not def_lines:  # a method (top level of the class)
                    c_ctor = child.name in _CTOR_METHODS
                    c_locked = False
                else:
                    # a def nested inside __init__ (e.g. a thread body
                    # handed to threading.Thread) runs AFTER construction
                    # — its writes are not constructor writes
                    c_ctor = False
            elif isinstance(child, (ast.With, ast.AsyncWith)):
                if any(_is_lockish(item.context_expr)
                       for item in child.items):
                    c_locked = True
            elif isinstance(child, ast.stmt) and not c_ctor:
                for attr, line in _self_attr_stores(child):
                    writes.append(_AttrWrite(attr, line, c_locked, c_defs))
            walk(child, c_locked, c_ctor, c_defs)

    walk(cls, False, False, ())
    return writes


def check_lock_discipline(rel: str, tree: ast.AST,
                          supp: Suppressions) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        writes = _walk_class_writes(node)
        locked_attrs = {w.attr for w in writes if w.locked}
        for w in writes:
            if w.locked or w.attr not in locked_attrs:
                continue
            if supp.suppressed("lock-discipline", w.line, *w.def_lines):
                continue
            out.append(Finding(
                rel, w.line, "lock-discipline",
                f"self.{w.attr} is written under a lock elsewhere in "
                f"{node.name} but without one here — either take the "
                f"lock or suppress with a comment explaining why this "
                f"write cannot race"))
    return out


def check_silent_except(rel: str, tree: ast.AST,
                        supp: Suppressions) -> List[Finding]:
    """Suppressions for this rule sit on the handler line itself —
    no enclosing-def resolution."""

    out: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        bare = node.type is None
        broad = (isinstance(node.type, ast.Name)
                 and node.type.id in ("Exception", "BaseException"))
        body_silent = all(
            isinstance(s, ast.Pass)
            or (isinstance(s, ast.Expr)
                and isinstance(s.value, ast.Constant))
            for s in node.body)
        if not (bare or (broad and body_silent)):
            continue
        if supp.suppressed("silent-except", node.lineno):
            continue
        what = ("bare `except:`" if bare else
                f"`except {node.type.id}: pass`")  # type: ignore[union-attr]
        out.append(Finding(
            rel, node.lineno, "silent-except",
            f"{what} swallows failures invisibly — log via "
            f"tpumon_torch.log.warn_every/vlog (or suppress with a comment "
            f"saying why silence is correct)"))
    return out


def check_wallclock(rel: str, tree: ast.AST,
                    supp: Suppressions) -> List[Finding]:
    out: List[Finding] = []
    # track enclosing def lines so a def-line pragma covers a whole helper
    def walk(node: ast.AST, def_lines: Tuple[int, ...]) -> None:
        for child in ast.iter_child_nodes(node):
            c_defs = def_lines
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                c_defs = def_lines + _def_header_lines(child)
            if (isinstance(child, ast.Call)
                    and isinstance(child.func, ast.Attribute)
                    and child.func.attr == "time"
                    and isinstance(child.func.value, ast.Name)
                    and child.func.value.id == "time"):
                if not supp.suppressed("wallclock-in-sampling",
                                       child.lineno, *c_defs):
                    out.append(Finding(
                        rel, child.lineno, "wallclock-in-sampling",
                        "time.time() in a sampling path: NTP steps skew "
                        "deadlines/intervals — use time.monotonic(), or "
                        "suppress where a wall-clock timestamp is the "
                        "API"))
            walk(child, c_defs)

    walk(tree, ())
    return out


_HOT_TEXT_ATTRS = ("encode", "splitlines")


def check_encode_in_hot_path(rel: str, tree: ast.AST,
                             supp: Suppressions) -> List[Finding]:
    """Flag ``<expr>.encode(...)`` / ``<expr>.splitlines(...)`` in the
    exporter sweep path.  Legitimate sites — the differential-oracle
    renderer, once-per-file-change parses, per-publish encodes — carry a
    suppression pragma with a comment saying why; anything new has to
    argue its case the same way."""

    out: List[Finding] = []

    def walk(node: ast.AST, def_lines: Tuple[int, ...]) -> None:
        for child in ast.iter_child_nodes(node):
            c_defs = def_lines
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                c_defs = def_lines + _def_header_lines(child)
            if (isinstance(child, ast.Call)
                    and isinstance(child.func, ast.Attribute)
                    and child.func.attr in _HOT_TEXT_ATTRS):
                # a wrapped call may carry its pragma on any of its
                # lines (first through last), or on an enclosing def
                span = range(child.lineno,
                             (child.end_lineno or child.lineno) + 1)
                if not supp.suppressed("encode-in-hot-path",
                                       *span, *c_defs):
                    out.append(Finding(
                        rel, child.lineno, "encode-in-hot-path",
                        f".{child.func.attr}() in the exporter sweep "
                        f"path: render/merge/serve are incremental and "
                        f"bytes-oriented — cache the encoded form, or "
                        f"suppress with a comment explaining why this "
                        f"runs less than once per sweep"))
            walk(child, c_defs)

    walk(tree, ())
    return out


def check_json_in_sweep_path(rel: str, tree: ast.AST,
                             supp: Suppressions) -> List[Finding]:
    """Flag ``json.loads(...)`` / ``json.dumps(...)`` in the client
    sweep-path files.  Sibling of :func:`check_encode_in_hot_path` for
    the collection plane: the binary ``sweep_frame`` op exists so the
    1 Hz hot path never JSON-encodes/-parses a full host snapshot —
    negotiation and oracle-fallback sites carry suppressions saying
    why."""

    out: List[Finding] = []

    def walk(node: ast.AST, def_lines: Tuple[int, ...]) -> None:
        for child in ast.iter_child_nodes(node):
            c_defs = def_lines
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                c_defs = def_lines + _def_header_lines(child)
            if (isinstance(child, ast.Call)
                    and isinstance(child.func, ast.Attribute)
                    and child.func.attr in ("loads", "dumps")
                    and isinstance(child.func.value, ast.Name)
                    and child.func.value.id == "json"):
                span = range(child.lineno,
                             (child.end_lineno or child.lineno) + 1)
                if not supp.suppressed("json-in-sweep-path",
                                       *span, *c_defs):
                    out.append(Finding(
                        rel, child.lineno, "json-in-sweep-path",
                        f"json.{child.func.attr}() in the client sweep "
                        f"path: the sweep RPC is binary delta frames "
                        f"(tpumon_torch/sweepframe.py) — use the wire codec, "
                        f"or suppress with a comment naming this as a "
                        f"negotiation/oracle/non-sweep-op site"))
            walk(child, c_defs)

    walk(tree, ())
    return out


#: attribute names whose call is a per-append durability syscall in the
#: flight recorder.  ``flush`` is included on purpose: the policy is
#: TIME-based flushing, so every flush site must argue (via pragma)
#: that it runs on the interval or at a caller-requested durability
#: point — never per record.
_FSYNC_ATTRS = ("fsync", "fdatasync", "flush")


def check_fsync_in_hot_path(rel: str, tree: ast.AST,
                            supp: Suppressions) -> List[Finding]:
    """Flag ``os.fsync(...)`` / ``os.fdatasync(...)`` / ``<f>.flush()``
    in the flight-recorder files.  The recorder's durability model is
    bounded loss (torn-tail recovery covers a crash); paying a sync per
    sweep would move disk latency into the sweep cadence — exactly the
    stall class the time-based flush policy exists to prevent."""

    out: List[Finding] = []

    def walk(node: ast.AST, def_lines: Tuple[int, ...]) -> None:
        for child in ast.iter_child_nodes(node):
            c_defs = def_lines
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                c_defs = def_lines + _def_header_lines(child)
            if (isinstance(child, ast.Call)
                    and isinstance(child.func, ast.Attribute)
                    and child.func.attr in _FSYNC_ATTRS):
                span = range(child.lineno,
                             (child.end_lineno or child.lineno) + 1)
                if not supp.suppressed("fsync-in-hot-path",
                                       *span, *c_defs):
                    out.append(Finding(
                        rel, child.lineno, "fsync-in-hot-path",
                        f".{child.func.attr}() in the flight-recorder "
                        f"append path: segment appends must not sync "
                        f"per sweep — flushing is time-based, so either "
                        f"route through the timed-flush helper or "
                        f"suppress with a comment explaining why this "
                        f"site runs less than once per sweep"))
            walk(child, c_defs)

    walk(tree, ())
    return out


#: method names whose mere call is a blocking primitive in the poller.
#: ``recv``/``send`` are NOT here: on a non-blocking socket they are the
#: required idiom, and the ``setblocking`` check below guarantees no
#: socket in the file is ever switched back to blocking mode.
_BLOCKING_SOCKET_ATTRS = ("settimeout", "makefile", "sendall", "accept")


def setblocking_pinned_nonblocking(call: ast.Call) -> bool:
    """True when a ``.setblocking(...)`` call provably pins
    non-blocking mode: any falsy constant argument (``False``, ``0``).
    Shared with ``tpumon_torch/tools/tpumon_check.py`` so the twin rules cannot
    drift on this predicate."""

    arg = call.args[0] if call.args else None
    return isinstance(arg, ast.Constant) and not arg.value


def check_blocking_socket(rel: str, tree: ast.AST,
                          supp: Suppressions) -> List[Finding]:
    """Flag blocking socket primitives in the fleet multiplexer: any
    ``.settimeout()`` / ``.makefile()`` / ``.sendall()`` / ``.accept()``
    call, ``.setblocking(x)`` where ``x`` is not the constant ``False``,
    and ``time.sleep()``.  The poller is one thread for the whole
    slice — a single blocking call stalls every host's sweep, which is
    exactly the thread-pool pathology the multiplexer replaced."""

    out: List[Finding] = []

    def flag(node: ast.Call, what: str, def_lines: Tuple[int, ...]) -> None:
        span = range(node.lineno, (node.end_lineno or node.lineno) + 1)
        if not supp.suppressed("blocking-socket-in-fleetpoll",
                               *span, *def_lines):
            out.append(Finding(
                rel, node.lineno, "blocking-socket-in-fleetpoll",
                f"{what} in the single-threaded fleet multiplexer "
                f"stalls every host's sweep — sockets must be "
                f"non-blocking and deadlines must come from the "
                f"loop's monotonic clock (or suppress with a comment "
                f"explaining why this cannot block the loop)"))

    def walk(node: ast.AST, def_lines: Tuple[int, ...]) -> None:
        for child in ast.iter_child_nodes(node):
            c_defs = def_lines
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                c_defs = def_lines + _def_header_lines(child)
            if (isinstance(child, ast.Call)
                    and isinstance(child.func, ast.Attribute)):
                attr = child.func.attr
                if attr in _BLOCKING_SOCKET_ATTRS:
                    flag(child, f".{attr}()", c_defs)
                elif attr == "setblocking":
                    if not setblocking_pinned_nonblocking(child):
                        flag(child, ".setblocking() not pinned to "
                                    "False", c_defs)
                elif (attr == "sleep"
                      and isinstance(child.func.value, ast.Name)
                      and child.func.value.id == "time"):
                    flag(child, "time.sleep()", c_defs)
            walk(child, c_defs)

    walk(tree, ())
    return out


#: call targets that allocate per call — banned in a fold function
#: (besides comprehensions/displays, which the rule flags directly)
_BURST_ALLOC_CALLS = frozenset({
    "list", "dict", "set", "tuple", "sorted", "deepcopy", "copy",
    "bytearray", "frozenset",
})


def check_mutex_in_burst_loop(rel: str, tree: ast.AST,
                              supp: Suppressions) -> List[Finding]:
    """Flag, inside any ``fold*`` function in the burst module:
    ``with <lock>``, ``.acquire()`` calls, allocation-heavy builtins
    (list/dict/set/sorted/...), and comprehension/display allocations.
    The inner loop is the single-producer half of the lock-free
    handoff — anything heavier argues its case via a suppression."""

    out: List[Finding] = []

    def flag(node: ast.AST, what: str,
             def_lines: Tuple[int, ...]) -> None:
        line = node.lineno  # type: ignore[attr-defined]
        end = getattr(node, "end_lineno", None) or line
        if not supp.suppressed("mutex-in-burst-loop",
                               *range(line, end + 1), *def_lines):
            out.append(Finding(
                rel, line, "mutex-in-burst-loop",
                f"{what} in a burst inner-loop fold function: the fold "
                f"runs 50-100x/s per (chip, field) on the lock-free "
                f"single-producer path — keep it to local-variable "
                f"ops, or suppress with a comment explaining why this "
                f"cannot run per sample"))

    def walk_fold(node: ast.AST, def_lines: Tuple[int, ...]) -> None:
        for child in ast.iter_child_nodes(node):
            c_defs = def_lines
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                c_defs = def_lines + _def_header_lines(child)
            if isinstance(child, (ast.With, ast.AsyncWith)) and any(
                    _is_lockish(item.context_expr)
                    for item in child.items):
                flag(child, "lock acquisition (`with <lock>`)", c_defs)
            elif isinstance(child, ast.Call):
                if (isinstance(child.func, ast.Attribute)
                        and child.func.attr == "acquire"):
                    flag(child, ".acquire()", c_defs)
                elif (isinstance(child.func, ast.Name)
                      and child.func.id in _BURST_ALLOC_CALLS):
                    flag(child, f"{child.func.id}() allocation", c_defs)
            elif isinstance(child, (ast.ListComp, ast.SetComp,
                                    ast.DictComp, ast.GeneratorExp,
                                    ast.List, ast.Dict, ast.Set)):
                flag(child, "per-sample container allocation", c_defs)
            walk_fold(child, c_defs)

    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name.startswith(_BURST_FOLD_PREFIX):
            walk_fold(node, _def_header_lines(node))
    return out


def check_finally_control_flow(rel: str, tree: ast.AST,
                               supp: Suppressions) -> List[Finding]:
    """Flag ``return``/``break``/``continue`` inside a ``finally``
    block: while an exception is in flight, any of them silently
    discards it (the language rule everyone forgets) — teardown code
    is exactly where a swallowed error hides longest.  ``break``/
    ``continue`` are fine when their target loop is itself inside the
    ``finally``; nested function definitions are their own scope."""

    out: List[Finding] = []

    def flag(node: ast.AST, what: str,
             def_lines: Tuple[int, ...]) -> None:
        line = node.lineno  # type: ignore[attr-defined]
        if not supp.suppressed("finally-control-flow", line, *def_lines):
            out.append(Finding(
                rel, line, "finally-control-flow",
                f"`{what}` inside a `finally` block silently discards "
                f"an in-flight exception — move it out of the finally "
                f"(or suppress with a comment explaining why "
                f"swallowing is intended)"))

    def scan_final(node: ast.AST, in_loop: bool,
                   def_lines: Tuple[int, ...]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            return  # a new scope: its control flow is its own
        if isinstance(node, ast.Return):
            flag(node, "return", def_lines)
        elif isinstance(node, ast.Break) and not in_loop:
            flag(node, "break", def_lines)
        elif isinstance(node, ast.Continue) and not in_loop:
            flag(node, "continue", def_lines)
        nested = in_loop or isinstance(node, (ast.For, ast.AsyncFor,
                                              ast.While))
        for child in ast.iter_child_nodes(node):
            scan_final(child, nested, def_lines)

    def walk(node: ast.AST, def_lines: Tuple[int, ...]) -> None:
        for child in ast.iter_child_nodes(node):
            c_defs = def_lines
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                c_defs = def_lines + _def_header_lines(child)
            if isinstance(child, ast.Try):
                for s in child.finalbody:
                    scan_final(s, False, c_defs)
            walk(child, c_defs)

    walk(tree, ())
    return out


# -- catalog snapshot ----------------------------------------------------------

@dataclass(frozen=True)
class FamilyRow:
    fid: int
    name: str           # CLI short name
    prom_name: str
    ptype: str          # "gauge" | "counter" | "label"
    help: str
    vector_label: str = ""
    declared_id: Optional[int] = None  # FieldMeta.field_id (None = fid)


@dataclass
class CatalogSnapshot:
    """The data the cross-artifact rules compare — decoupled from the
    live ``tpumon_torch.fields`` module so fixtures can build synthetic
    ones."""

    families: Dict[int, FamilyRow]
    sets: Dict[str, List[int]] = dc_field(default_factory=dict)

    def set_bitmask(self, fid: int) -> int:
        mask = 0
        if fid in self.sets.get("base", ()):
            mask |= 1
        if fid in self.sets.get("profiling", ()):
            mask |= 2
        if fid in self.sets.get("dcn", ()):
            mask |= 4
        if fid in self.sets.get("burst", ()):
            mask |= 8
        return mask

    def set_name(self, fid: int) -> str:
        if fid in self.sets.get("base", ()):
            return "base"
        if fid in self.sets.get("profiling", ()):
            return "profiling (-p)"
        if fid in self.sets.get("dcn", ()):
            return "dcn (--dcn)"
        if fid in self.sets.get("burst", ()):
            return "burst (--burst)"
        return "api-only"


def load_catalog_snapshot(repo: str) -> CatalogSnapshot:
    if repo not in sys.path:
        sys.path.insert(0, repo)
    from tpumon_torch import fields as FF

    fams = {
        fid: FamilyRow(fid=fid, name=m.name, prom_name=m.prom_name,
                       ptype=m.ftype.value, help=m.help,
                       vector_label=m.vector_label,
                       declared_id=m.field_id)
        for fid, m in FF.CATALOG.items()
    }
    sets = {
        "base": list(FF.EXPORTER_BASE_FIELDS),
        "profiling": list(FF.EXPORTER_PROFILING_FIELDS),
        "dcn": list(FF.EXPORTER_DCN_FIELDS),
        "burst": list(FF.EXPORTER_BURST_FIELDS),
        "status": list(FF.STATUS_FIELDS),
        "dmon": list(FF.DMON_FIELDS),
        "per_link": list(FF.PER_LINK_ICI_FIELDS),
    }
    return CatalogSnapshot(families=fams, sets=sets)


_INC_ROW = re.compile(
    r'\{\s*(\d+)\s*,\s*"([^"]*)"\s*,\s*"([^"]*)"\s*,\s*"([^"]*)"\s*,'
    r'\s*"([^"]*)"\s*,\s*(\d+)\s*\}')


def check_catalog_native_sync(snap: CatalogSnapshot, inc_text: str,
                              inc_path: str = CATALOG_INC,
                              ) -> List[Finding]:
    out: List[Finding] = []
    rows: Dict[int, Tuple[int, str, str, str, str, int]] = {}
    for i, line in enumerate(inc_text.splitlines(), start=1):
        m = _INC_ROW.search(line)
        if m:
            fid = int(m.group(1))
            rows[fid] = (i, m.group(2), m.group(3), m.group(4),
                         m.group(5), int(m.group(6)))
    exported = {fid: fam for fid, fam in snap.families.items()
                if fam.ptype != "label"}
    for fid, fam in sorted(exported.items()):
        row = rows.pop(fid, None)
        if row is None:
            out.append(Finding(
                inc_path, 0, "catalog-native-sync",
                f"field {fid} ({fam.prom_name}) missing from the native "
                f"catalog — run python -m "
                f"tpumon_torch.native.gen_catalog_header"))
            continue
        line_no, prom, ptype, help_, vec, mask = row
        expect = (fam.prom_name, fam.ptype, fam.help, fam.vector_label,
                  snap.set_bitmask(fid))
        got = (prom, ptype, help_, vec, mask)
        if expect != got:
            out.append(Finding(
                inc_path, line_no, "catalog-native-sync",
                f"field {fid} row {got!r} != fields.py {expect!r} — "
                f"run python -m "
                f"tpumon_torch.native.gen_catalog_header"))
    for fid, (line_no, prom, *_rest) in sorted(rows.items()):
        out.append(Finding(
            inc_path, line_no, "catalog-native-sync",
            f"stale native row for unknown/label field {fid} ({prom})"))
    return out


_DOC_ROW = re.compile(
    r"^\|\s*(\d+)\s*\|\s*(\S+)\s*\|\s*`([^`]+)`\s*\|\s*(\w+)\s*\|"
    r"\s*([^|]*?)\s*\|\s*([^|]*?)\s*\|\s*([^|]*?)\s*\|\s*(.*?)\s*\|\s*$")


def check_catalog_doc_sync(snap: CatalogSnapshot, doc_text: str,
                           doc_path: str = METRICS_DOC,
                           ) -> List[Finding]:
    out: List[Finding] = []
    rows: Dict[int, Tuple[int, str, str, str, str, str]] = {}
    for i, line in enumerate(doc_text.splitlines(), start=1):
        m = _DOC_ROW.match(line)
        if m:
            rows[int(m.group(1))] = (i, m.group(3), m.group(4),
                                     m.group(6), m.group(7), m.group(8))
    for fid, fam in sorted(snap.families.items()):
        row = rows.pop(fid, None)
        if row is None:
            out.append(Finding(
                doc_path, 0, "catalog-doc-sync",
                f"field {fid} ({fam.prom_name}) undocumented — run "
                f"python -m tpumon_torch.tools.gen_metrics_doc"))
            continue
        line_no, prom, ptype, vec, setname, help_ = row
        expect = (fam.prom_name, fam.ptype, fam.vector_label or "—",
                  snap.set_name(fid), fam.help)
        got = (prom, ptype, vec, setname, help_)
        if expect != got:
            out.append(Finding(
                doc_path, line_no, "catalog-doc-sync",
                f"field {fid} doc row {got!r} != fields.py {expect!r} — "
                f"run python -m tpumon_torch.tools.gen_metrics_doc"))
    for fid, (line_no, prom, *_rest) in sorted(rows.items()):
        out.append(Finding(
            doc_path, line_no, "catalog-doc-sync",
            f"doc row for field {fid} ({prom}) not in the catalog — run "
            f"python -m tpumon_torch.tools.gen_metrics_doc"))
    return out


def check_catalog_sets(snap: CatalogSnapshot,
                       path: str = "tpumon_torch/fields.py") -> List[Finding]:
    out: List[Finding] = []
    for set_name, fids in sorted(snap.sets.items()):
        seen: Set[int] = set()
        for fid in fids:
            if fid in seen:
                out.append(Finding(
                    path, 0, "catalog-set-membership",
                    f"field {fid} listed twice in {set_name}"))
            seen.add(fid)
            fam = snap.families.get(fid)
            if fam is None:
                out.append(Finding(
                    path, 0, "catalog-set-membership",
                    f"{set_name} references field {fid} which is not in "
                    f"CATALOG"))
            elif fam.ptype == "label" and set_name in (
                    "base", "profiling", "dcn", "burst", "status",
                    "dmon"):
                out.append(Finding(
                    path, 0, "catalog-set-membership",
                    f"{set_name} includes LABEL field {fid} "
                    f"({fam.prom_name}): labels are identity, not "
                    f"samples"))
    for a, b in (("base", "profiling"), ("base", "dcn"),
                 ("profiling", "dcn"), ("base", "burst"),
                 ("profiling", "burst"), ("dcn", "burst")):
        overlap = set(snap.sets.get(a, ())) & set(snap.sets.get(b, ()))
        for fid in sorted(overlap):
            out.append(Finding(
                path, 0, "catalog-set-membership",
                f"field {fid} is in both {a} and {b} exporter sets — "
                f"the family would be emitted twice per sweep"))
    return out


_PROM_NAME = re.compile(r"^tpu_[a-z0-9_]+$")


def check_prom_name_style(snap: CatalogSnapshot,
                          path: str = "tpumon_torch/fields.py") -> List[Finding]:
    out: List[Finding] = []
    by_prom: Dict[str, int] = {}
    by_short: Dict[str, int] = {}
    for fid, fam in sorted(snap.families.items()):
        if fam.declared_id is not None and fam.declared_id != fid:
            out.append(Finding(
                path, 0, "prom-name-style",
                f"CATALOG key {fid} disagrees with its "
                f"FieldMeta.field_id {fam.declared_id}"))
        if not _PROM_NAME.match(fam.prom_name):
            out.append(Finding(
                path, 0, "prom-name-style",
                f"field {fid} family {fam.prom_name!r} must match "
                f"{_PROM_NAME.pattern}"))
        prev = by_prom.setdefault(fam.prom_name, fid)
        if prev != fid:
            out.append(Finding(
                path, 0, "prom-name-style",
                f"family {fam.prom_name!r} claimed by fields {prev} "
                f"and {fid}"))
        prev = by_short.setdefault(fam.name, fid)
        if prev != fid:
            out.append(Finding(
                path, 0, "prom-name-style",
                f"short name {fam.name!r} claimed by fields {prev} "
                f"and {fid}"))
    return out


# -- entry points ------------------------------------------------------------

#: ``-m tpumon_torch.a.b`` as a shell command, a YAML block list
#: (``- -m`` / ``- tpumon_torch.a.b``) or an exec-form JSON array
#: (``"-m", "tpumon_torch.a.b"``)
_DASH_M = re.compile(
    r"(?<![\w-])-m(?:[\s\"',\[\]]|\n\s*-\s)*"
    r"(?P<mod>" + PKG + r"(?:\.\w+)+)")


def parse_module_commands(text: str) -> List[Tuple[int, str]]:
    """[(line, module)] for every ``-m tpumon_torch.<module>`` in one
    document, in order."""

    return [(text.count("\n", 0, m.start("mod")) + 1, m.group("mod"))
            for m in _DASH_M.finditer(text)]


def _module_file(repo: str, module: str) -> Optional[str]:
    base = os.path.join(repo, *module.split("."))
    for cand in (base + ".py", os.path.join(base, "__main__.py")):
        if os.path.isfile(cand):
            return cand
    return None


def _has_main_guard(tree: ast.Module) -> bool:
    """True when the module runs something under ``if __name__ ==
    "__main__":`` (a ``__main__.py`` runs its whole body)."""

    for node in tree.body:
        if isinstance(node, ast.If) and isinstance(node.test, ast.Compare):
            names = [node.test.left] + list(node.test.comparators)
            if any(isinstance(n, ast.Name) and n.id == "__name__"
                   for n in names) and any(
                       isinstance(n, ast.Constant) and n.value == "__main__"
                       for n in names):
                return True
    return False


def iter_entrypoint_docs(repo: str) -> Iterator[str]:
    for src in ENTRYPOINT_SOURCES:
        path = os.path.join(repo, src)
        if os.path.isfile(path):
            yield src
            continue
        for root, dirs, files in os.walk(path):
            dirs.sort()
            for name in sorted(files):
                rel = os.path.relpath(os.path.join(root, name), repo)
                yield rel.replace(os.sep, "/")


def check_entrypoints(repo: str) -> List[Finding]:
    out: List[Finding] = []
    for rel in iter_entrypoint_docs(repo):
        try:
            with open(os.path.join(repo, rel), encoding="utf-8") as f:
                text = f.read()
        except (OSError, UnicodeDecodeError):
            continue               # binaries and unreadable files run nothing
        for line_no, module in parse_module_commands(text):
            mod_file = _module_file(repo, module)
            if mod_file is None:
                out.append(Finding(
                    rel, line_no, "entrypoint-resolves",
                    f"python -m {module}: no module or package "
                    f"__main__.py of that name in the repo"))
                continue
            try:
                with open(mod_file, encoding="utf-8") as f:
                    tree = ast.parse(f.read(), filename=mod_file)
            except SyntaxError as e:
                out.append(Finding(
                    rel, line_no, "entrypoint-resolves",
                    f"python -m {module}: the module does not parse: {e}"))
                continue
            if not (mod_file.endswith("__main__.py")
                    or _has_main_guard(tree)):
                out.append(Finding(
                    rel, line_no, "entrypoint-resolves",
                    f"python -m {module}: the module has no "
                    f"`if __name__ == \"__main__\":` block — the command "
                    f"imports it and exits without running anything"))
    return out


# -- drivers -------------------------------------------------------------------

def check_python_file(repo: str, rel: str) -> List[Finding]:
    """All per-file AST rules for one repo-relative Python path."""

    abs_path = os.path.join(repo, rel)
    with open(abs_path, encoding="utf-8") as f:
        src = f.read()
    try:
        tree = ast.parse(src, filename=abs_path)
    except SyntaxError as e:
        return [Finding(rel, e.lineno or 0, "parse-error",
                        f"file does not parse: {e.msg}")]
    supp = Suppressions(src)
    findings: List[Finding] = []
    if rel.startswith(_SILENT_EXCEPT_SCOPE):
        findings += check_silent_except(rel, tree, supp)
    if rel.startswith(_SAMPLING_PREFIXES) or rel in _SAMPLING_FILES:
        findings += check_wallclock(rel, tree, supp)
    if rel in _HOT_TEXT_FILES:
        findings += check_encode_in_hot_path(rel, tree, supp)
    if rel in _SWEEP_JSON_FILES:
        findings += check_json_in_sweep_path(rel, tree, supp)
    if rel in _FLEETPOLL_FILES:
        findings += check_blocking_socket(rel, tree, supp)
    if rel in _BLACKBOX_FILES:
        findings += check_fsync_in_hot_path(rel, tree, supp)
    if rel in _BURST_FILES:
        findings += check_mutex_in_burst_loop(rel, tree, supp)
    if rel.startswith(PKG + "/"):
        findings += check_lock_discipline(rel, tree, supp)
        # a swallowed in-flight exception is a correctness bug in any
        # module, so this rule has no file scoping
        findings += check_finally_control_flow(rel, tree, supp)
    return findings


def iter_python_files(repo: str) -> Iterator[str]:
    for root, dirs, files in os.walk(os.path.join(repo, PKG)):
        dirs[:] = [d for d in dirs if d != "__pycache__"
                   and os.path.join(root, d) != os.path.join(repo,
                                                             TOOLS_DIR)]
        for name in sorted(files):
            if name.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, name), repo)
                yield rel.replace(os.sep, "/")


def run_repo(repo: str) -> List[Finding]:
    findings: List[Finding] = []
    for rel in iter_python_files(repo):
        findings += check_python_file(repo, rel)
    snap = load_catalog_snapshot(repo)
    inc = os.path.join(repo, CATALOG_INC)
    if os.path.isfile(inc):
        with open(inc, encoding="utf-8") as f:
            findings += check_catalog_native_sync(snap, f.read())
    else:
        findings.append(Finding(CATALOG_INC, 0,
                                "catalog-native-sync", "file missing"))
    doc = os.path.join(repo, METRICS_DOC)
    if os.path.isfile(doc):
        with open(doc, encoding="utf-8") as f:
            findings += check_catalog_doc_sync(snap, f.read())
    else:
        findings.append(Finding(METRICS_DOC, 0,
                                "catalog-doc-sync", "file missing"))
    findings += check_catalog_sets(snap)
    findings += check_prom_name_style(snap)
    findings += check_entrypoints(repo)
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="tpumon-lint",
        description="repo-aware static analysis for the port, "
                    "tpumon_torch (see tpumon_torch/docs/lint.md)")
    p.add_argument("--repo", default=None,
                   help="repo root (default: the directory holding "
                        "tpumon_torch/)")
    p.add_argument("--list-rules", action="store_true",
                   help="print rule names + descriptions and exit")
    args = p.parse_args(argv)
    if args.list_rules:
        for rule, desc in sorted(RULES.items()):
            print(f"{rule:24s} {desc}")
        return 0
    repo = args.repo or REPO_ROOT
    findings = run_repo(repo)
    for f in findings:
        print(f.render())
    n = len(findings)
    print(f"tpumon-lint: {n} finding{'s' if n != 1 else ''} "
          f"({len(RULES)} rules)")
    return 1 if findings else 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # `tpumon_lint | head` is not an error
        sys.exit(0)
