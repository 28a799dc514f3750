"""Spans of the port's monitor path: where a sweep, a scrape request or a
trace capture spends its time.

A span has a name, a start and an end in ``time.monotonic_ns`` (the
process's ``CLOCK_MONOTONIC``, the clock the agent and the scraper
stamp with too), a parent, and the id of the root it belongs to: the
sweep, request or capture.  Its name is its path from that root,
``sweep.collect.probe.drain``.

A root opens on a :class:`Recorder` (``with rec.root("sweep"):``); inside
it, :func:`span` opens a child of the innermost span open on the calling
thread, so the backend's and the probes' phases nest under the sweep that
reads them without being handed it.  Outside any root :func:`span` costs
one thread-local read and records nothing.  A tree whose phases ran on
more than one thread (a trace capture: opened and closed on the job's
thread, parsed on a daemon thread) is recorded whole once it ends
(:meth:`Recorder.record`).

Finished spans go into per-name aggregates (count and total) and, where
the recorder is given a capacity, a bounded ring; the last finished tree
of each root name is kept whole for the self-metrics that serve it.
Nothing is written anywhere else.

While the trace engine's own profiler session is open (:data:`mirroring`,
which the engine sets and clears around each session it opens), a live
span is mirrored as a ``record_function`` range named ``tpumon.<name>``,
so it lands on the capture's own clock and names the idle gap under it;
the engine's parse leaves these ranges out (:data:`PREFIX`).  A session
opened elsewhere (:func:`tpumon_torch.trace.profiler_session`) gets no
ranges, and outside a session none is entered; a process that has not
imported ``torch`` never imports it here.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

#: the profiler ranges' name prefix
PREFIX = "tpumon."
#: set while the trace engine's own profiler session is open: live spans
#: are then mirrored as profiler ranges
mirroring = False

_local = threading.local()
_ids = itertools.count(1)


class Span(NamedTuple):
    """One finished span."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    #: the parent's id, 0 for a root
    parent: int
    #: the root's id (a root's own)
    root: int

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


def _stack() -> List["_Open"]:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Open:
    """A live span: a context manager on the thread that opened it."""

    __slots__ = ("rec", "name", "start_ns", "id", "parent", "root",
                 "done", "rf")

    def __init__(self, rec: "Recorder", name: str, parent: Optional["_Open"],
                 start_ns: Optional[int] = None) -> None:
        self.rec = rec
        self.name = name if parent is None else f"{parent.name}.{name}"
        self.start_ns = time.monotonic_ns() if start_ns is None else start_ns
        self.id = next(_ids)
        self.parent = parent
        #: the root, None for a root itself (no reference cycle: a
        #: finished tree is freed as soon as it is left)
        self.root: Optional[_Open] = \
            None if parent is None else (parent.root or parent)
        #: a root's finished descendants, in the order they ended
        self.done: Optional[List[Span]] = [] if parent is None else None
        self.rf = None

    def __enter__(self) -> "_Open":
        _stack().append(self)
        if mirroring:
            from torch.autograd.profiler import record_function

            self.rf = record_function(PREFIX + self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        end = time.monotonic_ns()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        self.rec._finish(self, end)

    def add(self, name: str, start_ns: int, end_ns: int) -> Span:
        """Record a finished child that ran before it could be opened (a
        request's wait for its thread)."""

        child = _Open(self.rec, name, self, start_ns)
        return self.rec._finish(child, end_ns)


class _Null:
    """What :func:`span` returns outside any root."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


_NULL = _Null()


def span(name: str):
    """A child of the innermost span open on this thread, as a context
    manager; records nothing outside a root."""

    stack = _stack()
    if not stack:
        return _NULL
    parent = stack[-1]
    return _Open(parent.rec, name, parent)


def current() -> Optional[_Open]:
    """The innermost span open on this thread, or None."""

    stack = _stack()
    return stack[-1] if stack else None


class Recorder:
    """Finished spans: per-name aggregates, the last tree of each root
    name and, given a ``capacity``, a ring of the latest spans.  Safe to
    share between threads."""

    def __init__(self, capacity: int = 0) -> None:
        self._lock = threading.Lock()
        self._ring: Optional["deque[Span]"] = \
            deque(maxlen=capacity) if capacity > 0 else None
        #: name -> [count, total ns]
        self._agg: Dict[str, List[int]] = {}
        #: root name -> its last finished tree, the root last
        self._last: Dict[str, Tuple[Span, ...]] = {}

    def root(self, name: str, start_ns: Optional[int] = None) -> _Open:
        """A root span as a context manager; ``start_ns`` backdates it."""

        return _Open(self, name, None, start_ns)

    def record(self, name: str, start_ns: int, end_ns: int,
               children: Sequence[Tuple[str, int, int]] = ()) -> Span:
        """Record a finished root and its finished children, each
        ``(name, start_ns, end_ns)``."""

        root = _Open(self, name, None, start_ns)
        for child, s, e in children:
            root.add(child, s, e)
        return self._finish(root, end_ns)

    def _finish(self, op: _Open, end_ns: int) -> Span:
        dur = end_ns - op.start_ns
        parent, root = op.parent, op.root or op
        sp = tuple.__new__(Span, (op.name, op.start_ns, end_ns, op.id,
                                  0 if parent is None else parent.id,
                                  root.id))
        with self._lock:
            if self._ring is not None:
                self._ring.append(sp)
            agg = self._agg.get(sp.name)
            if agg is None:
                agg = self._agg[sp.name] = [0, 0]
            agg[0] += 1
            agg[1] += dur
            root.done.append(sp)
            if parent is None:
                self._last[sp.name] = tuple(root.done)
        return sp

    def last(self, name: str) -> Tuple[Span, ...]:
        """The last finished tree of root ``name`` (its descendants in the
        order they ended, then the root), or ()."""

        with self._lock:
            return self._last.get(name, ())

    def latest(self, name: str) -> Tuple[int, Tuple[Span, ...]]:
        """(roots named ``name`` finished so far, the last one's tree),
        read together."""

        with self._lock:
            agg = self._agg.get(name)
            return (agg[0] if agg is not None else 0,
                    self._last.get(name, ()))

    def spans(self) -> List[Span]:
        """The ring, oldest first ([] without one)."""

        with self._lock:
            return list(self._ring or ())

    def aggregates(self) -> Dict[str, Tuple[int, float]]:
        """name -> (count, total seconds)."""

        with self._lock:
            return {k: (v[0], v[1] / 1e9) for k, v in self._agg.items()}


def seconds(tree: Sequence[Span]) -> Dict[str, float]:
    """name -> summed seconds of a tree's spans (a phase that ran twice in
    one root counts once, with both durations)."""

    out: Dict[str, float] = {}
    for sp in tree:
        out[sp.name] = out.get(sp.name, 0.0) + sp.ns / 1e9
    return out
