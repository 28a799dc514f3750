"""The port's metrics agent: one process per GPU host, observed once,
serving every monitor client.

    python -m tpumon_torch.hostengine --domain-socket /run/tpumon.sock
    python -m tpumon_torch.hostengine --port 5555 --burst-hz 100
    python -m tpumon_torch.hostengine --domain-socket S --fake \\
        --fake-chips 4 --fake-epoch 1700000000.0 --allow-inject

The counterpart of the reference's native ``tpu-hostengine``
(``native/agent/main.cc`` with ``sampler.hpp``): the same op set, reply
shapes and binary ``sweep_frame`` delta frames
(``native/agent/protocol.md``), so the reference's client and the port's
(:class:`tpumon_torch.backends.agent.AgentBackend`) work against either
daemon.  It serves a :class:`~tpumon_torch.backends.base.Backend` on the
port's :class:`~tpumon_torch.frameserver.FrameServer`:

* without ``--fake``, :class:`~tpumon_torch.backends.nvml.NvmlBackend`; a
  host where NVML loads no device makes the agent exit 3, and nothing is
  ever served in its place.  The agent never imports ``torch`` and
  creates no CUDA context (``libcuda`` only through ``nvmlInit_v2``);
* with ``--fake``, :class:`AgentFakeBackend`: the port's ``FakeBackend``
  under the native ``FakeSource``'s identities and field set, so the two
  daemons answer alike (``tests/test_torch_agent.py``).

Ops: ``hello``, ``chip_info``, ``read_fields``, ``read_fields_bulk``
(``max_age_s``, ``events_since``), ``watch``/``unwatch`` (a
:class:`~tpumon_torch.watch.WatchManager` sweeping at the fastest watched
rate into age-bounded series; watches are scoped to the connection), ``latest``, ``samples``, ``topology``, ``processes``,
``events``, ``introspect``, ``inject`` (with ``--allow-inject``, over the
fake only), ``term``, and ``sweep_frame`` (JSON probe, then binary
requests; one delta table per connection).  Numbers follow the native
agent's convention: a finite integral value below 9e15 travels as an
integer, a non-finite one as blank.

``--burst-hz HZ`` runs :class:`tpumon_torch.burst.BurstSampler` over the
backend's ``read_burst_fields`` and serves the derived fields (ids
``2000 + 4 * source + agg``) from its 1 s harvests; ``hello`` then carries
``burst_hz`` and ``burst_overruns``.

The data plane of a DaemonSet, with no exporter process (the native
agent's flags, ``native/agent/main.cc:1625-1680``):

* ``--prom-port N`` serves ``/metrics`` and ``/healthz`` over HTTP on every
  interface (0: a kernel-assigned port, announced on stderr as
  ``serving /metrics on port N``): every scrape family of the catalog from
  the watches' cache or a live read, rendered by the port's
  :mod:`.exporter.promtext` (HELP/TYPE once a family, ``{chip,uuid,model}``
  labels, blank values omitted), then the agent's self-metrics.
  ``/healthz`` fails (503) once the source has no device or its first
  device stops answering.
* ``--merge-textfile GLOB`` (repeatable) and ``--merge-max-age S``: fresh
  drop files merged into every scrape (:mod:`.exporter.textmerge`, the
  exporter's merge).  Without NVML's library on the host, merge globs
  start merge-only mode: no device, the drop files and the self-metrics.
  An NVML that is present but fails still exits 3.
* ``--kubelet-socket PATH`` and ``--pod-resource NAME``: pod labels by GPU
  UUID from the kubelet's pod-resources API (default ``nvidia.com/gpu``).
* ``--kmsg PATH``: the kernel log of the NVML source's Xid watcher,
  silently off where it cannot be read (the fake source reads none).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import signal
import socket
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import fields as FF
from . import log
from . import spans
from .backends.agent import DEFAULT_SOCKET
from .backends.base import (Backend, BackendError, ChipNotFound, FieldValue,
                            LibraryNotFound)
from .exporter.promtext import SweepRenderer, render_family
from .exporter.textmerge import TextfileMerge, index_lines, splice_lines
from .backends.fake import FakeBackend, FakeSliceConfig
from .burst import BurstSampler
from .events import Event, EventType
from .exporter.podresources import DEFAULT_RESOURCE
from .frameserver import ConnHandler, FrameConn, FrameServer
from .httputil import TextHTTPServer
from .introspect import _read_proc_stat
from .sweepframe import (NUM_INT_LIMIT, SweepFrameEncoder,
                         decode_sweep_request)
from .types import (ChipCoords, ChipInfo, P2PLink, P2PLinkType, TopologyInfo,
                    VersionInfo)
from .watch import WatchManager

AGENT_VERSION = "tpumon_torch-hostengine 0.1.0"

#: the field ids the native ``FakeSource`` serves (``source.hpp``,
#: ``read_field_at`` and ``read_vector``); every other id reads blank
FAKE_SCALAR_FIELDS = frozenset(
    [100, 101, 140, 150, 155, 156, 200, 201, 202, 203, 204, 206, 207, 208,
     230, 231, 240, 241, 242, 243, 244, 245, 250, 251, 252, 253,
     310, 311, 312, 313, 390, 391, 392, 409, 419, 429, 439, 449, 450]
    + list(range(1001, 1015)))
FAKE_VECTOR_FIELDS = frozenset([460, 461, 462, 463])
FAKE_DRIVER = "tpu-hostengine-fake 1.0.0"


def _num(v: float) -> FieldValue:
    """The native agent's number convention for one double: blank when
    non-finite, an ``int`` when integral below ``NUM_INT_LIMIT``."""

    if not math.isfinite(v):
        return None
    if v == math.floor(v) and abs(v) < NUM_INT_LIMIT:
        return int(v)
    return v


def wire_value(v: Any) -> FieldValue:
    """A backend value as the agent serves it: numbers by :func:`_num`
    (vector elements too), strings as they are, anything else blank."""

    if v is None or isinstance(v, str):
        return v
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, int):
        return v
    if isinstance(v, float):
        return _num(v)
    if isinstance(v, list):
        return [wire_value(e) if not isinstance(e, str) else None
                for e in v]
    return None


def _jsonable(obj: Any) -> Any:
    """A reply with every float under the number convention."""

    if isinstance(obj, float):
        return _num(obj)
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_jsonable(v) for v in obj]
    return obj


class AgentFakeBackend(FakeBackend):
    """The agent's ``--fake`` source: the port's :class:`FakeBackend`
    waveforms under the native ``FakeSource``'s identities (uuid
    ``TPU-agentfake-NN``, coordinates ``(i % 2, i // 2)``, driver
    ``tpu-hostengine-fake 1.0.0``), field set and topology rule, at a
    pinned epoch when one is given."""

    def __init__(self, chips: int = 4, epoch: float = 0.0) -> None:
        super().__init__(FakeSliceConfig(num_chips=chips,
                                         driver_version=FAKE_DRIVER,
                                         runtime_version=FAKE_DRIVER))
        self._epoch = float(epoch)

    def open(self) -> None:
        super().open()
        if self._epoch > 0:
            self._t0 = self._epoch

    def _uuid(self, index: int) -> str:
        return f"TPU-agentfake-{index:02d}"

    def chip_info(self, index: int) -> ChipInfo:
        info = super().chip_info(index)
        return dataclasses.replace(
            info, serial=f"AGENTFAKE{index:04d}", firmware="v5e-fw-agent-1",
            coords=ChipCoords(x=index % 2, y=index // 2),
            numa_node=index // 2)

    def read_fields(self, index: int, field_ids: Sequence[int],
                    now: Optional[float] = None) -> Dict[int, FieldValue]:
        fids = [int(f) for f in field_ids]
        served = [f for f in fids
                  if f in FAKE_SCALAR_FIELDS or f in FAKE_VECTOR_FIELDS]
        vals = super().read_fields(index, served, now=now)
        return {f: vals.get(f) for f in fids}

    def topology(self, index: int) -> TopologyInfo:
        """The native agent's rule: mesh from the chips' coordinates,
        torus distance in hops, CPUs split evenly across chips."""

        self._check(index)
        n = self.chip_count()
        infos = [self.chip_info(i) for i in range(n)]
        mx = max([1] + [i.coords.x + 1 for i in infos])
        my = max([1] + [i.coords.y + 1 for i in infos])
        me = infos[index].coords
        links = []
        for i, other in enumerate(infos):
            if i == index:
                continue
            dx = abs(me.x - other.coords.x)
            dy = abs(me.y - other.coords.y)
            hops = min(dx, mx - dx) + min(dy, my - dy)
            links.append(P2PLink(
                chip_index=i, bus_id=other.pci.bus_id,
                link=(P2PLinkType.ICI_NEIGHBOR if hops == 1
                      else P2PLinkType.ICI_SAME_SLICE),
                hops=hops))
        per = (os.cpu_count() or 8) // max(n, 1)
        return TopologyInfo(
            coords=me, cpu_affinity=f"{index * per}-{(index + 1) * per - 1}",
            numa_node=infos[index].numa_node, links=links,
            mesh_shape=(mx, my), wrap=(mx > 2, my > 2))


class EmptySource(Backend):
    """Merge-only mode's source: no device (the native agent's
    ``FakeSource(0)``)."""

    name = "none"

    def open(self) -> None:
        pass

    def close(self) -> None:
        pass

    def chip_count(self) -> int:
        return 0

    def chip_info(self, index: int) -> ChipInfo:
        raise ChipNotFound(f"no such chip {index}")

    def versions(self) -> VersionInfo:
        return VersionInfo()

    def read_fields(self, index: int, field_ids: Sequence[int],
                    now: Optional[float] = None) -> Dict[int, FieldValue]:
        raise ChipNotFound(f"no such chip {index}")


#: the scrape's families: the exporter's base, profiling and DCN sets
SCRAPE_FIELDS = sorted(set(int(f) for f in (
    list(FF.EXPORTER_BASE_FIELDS) + list(FF.EXPORTER_PROFILING_FIELDS)
    + list(FF.EXPORTER_DCN_FIELDS))))
#: the scrape's phase gauges, in the order they are served: (family,
#: help) (``main.cc`` ``kScrapePhases``, line for line)
SCRAPE_PHASES = (
    ("tpumon_agent_scrape_wait_ms",
     "Accepted to the scrape lock taken, this scrape."),
    ("tpumon_agent_scrape_collect_ms",
     "Burst harvest, watch cache and live reads of this scrape."),
    ("tpumon_agent_scrape_render_ms",
     "Catalog+self formatting time of this scrape, the collect excluded."),
    ("tpumon_agent_scrape_merge_ms", "Drop-file merge time of this scrape."),
    ("tpumon_agent_scrape_write_ms",
     "Socket write of the previous /metrics response."),
)
#: the self families the merge must never take from a drop file
_AGENT_MERGE_FAMILIES = ("tpumon_agent_merged_files",
                         "tpumon_agent_merged_series") + tuple(
                             fam for fam, _ in SCRAPE_PHASES)
#: how long a scrape's chip labels stand before they are read again (a
#: card replaced at the same index must not keep its old uuid)
LABEL_TTL_S = 10.0


class WatchSource:
    """The backend as the agent's watches read it (``sampler.hpp``): every
    chip read at the sweep's stamp, numbers only (a blank, string or
    vector value stores no sample, so ``latest`` serves the last number
    while it is fresh), and the samples stored counted for
    ``introspect``.  A :class:`~tpumon_torch.watch.WatchManager` over it
    is the agent's sampler; events are served by the ops, not by it."""

    def __init__(self, backend: Backend) -> None:
        self.backend = backend
        self.samples = 0

    def supported_chips(self) -> List[int]:
        return list(range(self.backend.chip_count()))

    def current_event_seq(self) -> int:
        return 0

    def sweep_fields_bulk(self, requests, now=None, max_age_s=None,
                          events_since=None):
        out: Dict[int, Dict[int, FieldValue]] = {}
        if not requests:
            return out, []
        for c, vals in self.backend.read_fields_bulk(requests,
                                                     now=now).items():
            num = {}
            for f, v in vals.items():
                v = wire_value(v)
                if isinstance(v, (int, float)):
                    num[f] = v
            self.samples += len(num)
            out[c] = num
        return out, []


class Engine:
    """The op set over one backend (``main.cc`` ``Server``).  Request ops
    run on the frame server's loop thread; the watches' sweep and the
    burst loop have threads of their own."""

    # tpumon: close-ok(the watch manager is a passive container until a client's first watch starts its sweep thread, so nothing it holds needs releasing when a later step raises; the burst sampler, the one member that starts a thread, is acquired last)
    def __init__(self, backend: Backend, *, allow_inject: bool = False,
                 burst_hz: int = 0,
                 on_term: Optional[Any] = None,
                 merge: Optional[TextfileMerge] = None,
                 pods: Optional[Any] = None) -> None:
        self.backend = backend
        #: the scrape's drop-file merge (``--merge-textfile``) and pod
        #: attribution (``--kubelet-socket``)
        self.merge = merge
        self.pods = pods
        self._prom_lock = threading.Lock()
        #: the /metrics requests' spans (the HTTP server's ``request``
        #: roots: ``wait``, ``payload``, ``write``)
        self.spans = spans.Recorder()
        #: serializes the burst harvest and the live-read count between
        #: the frame server's loop (sweeps, ops) and the HTTP scrape
        #: threads: a sampler has one consumer at a time
        self._harvest_lock = threading.Lock()
        self._prom_labels: List[Dict[str, str]] = []
        self._prom_labels_t = -1e18
        self.allow_inject = allow_inject
        #: agent-side watches: one sweep thread at the fastest watched
        #: rate, age-bounded series every connection reads (``latest``,
        #: ``samples``, the cache half of ``read_fields_bulk`` and
        #: ``sweep_frame``)
        self.source = WatchSource(backend)
        self.watches = WatchManager(self.source)
        self.requests = 0
        self.samples = 0
        self.start_time = time.time()
        #: the process's CPU seconds when the engine started: introspect's
        #: ``cpu_percent`` is the serving life's, without the start-up
        self._cpu0 = _read_proc_stat(os.getpid())[0]
        self._on_term = on_term
        self.burst: Optional[BurstSampler] = None
        self._burst_samples = 0
        self._harvest: Dict[int, Dict[int, FieldValue]] = {}
        if burst_hz > 0:
            self._start_burst(burst_hz)

    # -- burst ----------------------------------------------------------------

    def _start_burst(self, hz: int) -> None:
        reqs = [(c, list(FF.BURST_SOURCE_FIELDS))
                for c in range(self.backend.chip_count())]
        read = self.backend.read_burst_fields

        def sample() -> Dict[int, Dict[int, FieldValue]]:
            sweep = read(reqs)
            self._burst_samples += sum(
                1 for vals in sweep.values() for v in vals.values()
                if isinstance(v, (int, float)))
            return sweep

        self.burst = BurstSampler(sample, hz)
        self.burst.start()

    def _burst_covers(self, fid: int) -> bool:
        return self.burst is not None and FF.burst_source(fid) is not None

    def _harvest_if_due(self) -> None:
        if self.burst is not None:
            with self._harvest_lock:
                self._harvest = self.burst.harvest_if_due(time.monotonic())

    def _burst_value(self, chip: int, fid: int) -> FieldValue:
        v = self._harvest.get(chip, {}).get(fid)
        return wire_value(float(v)) if isinstance(v, (int, float)) else None

    # -- reads ----------------------------------------------------------------

    def _chips(self) -> int:
        return self.backend.chip_count()

    def _live(self, wanted: Dict[int, List[int]]
              ) -> Dict[int, Dict[int, FieldValue]]:
        """One backend read of the (chip, fields) no cache served."""

        reqs = [(c, fids) for c, fids in wanted.items() if fids]
        with self._harvest_lock:
            self.samples += sum(len(f) for _, f in reqs)
        if not reqs:
            return {}
        return self.backend.read_fields_bulk(reqs)

    def _sweep(self, reqs: Sequence[Tuple[int, Sequence[int]]],
               max_age: Optional[float]
               ) -> Tuple[Dict[int, Dict[int, FieldValue]], List[int]]:
        """The values of a whole-host request, each (chip, field) from the
        burst harvest, the watches' cache (no older than ``max_age``) or a
        live read; and the chip indices that do not exist."""

        self._harvest_if_due()
        n = self._chips()
        # wall clock on purpose: ``max_age`` bounds the age of the
        # watches' samples, whose timestamps are wall-clock (the API)
        now = time.time()  # tpumon-lint: disable=wallclock-in-sampling
        out: Dict[int, Dict[int, FieldValue]] = {}
        bad: List[int] = []
        live: Dict[int, List[int]] = {}
        for idx, fids in reqs:
            idx = int(idx)
            if not 0 <= idx < n:
                bad.append(idx)
                continue
            vals = out.setdefault(idx, {})
            for fid in fids:
                fid = int(fid)
                if self._burst_covers(fid):
                    vals[fid] = self._burst_value(idx, fid)
                    continue
                hit = self.watches.latest(idx, fid, fresh=True)
                if hit is not None and (max_age is None or
                                        now - hit.timestamp <= max_age):
                    vals[fid] = hit.value
                else:
                    vals[fid] = None
                    live.setdefault(idx, []).append(fid)
        for idx, got in self._live(live).items():
            for fid in live.get(idx, ()):
                out[idx][fid] = wire_value(got.get(fid))
        return out, bad

    def _events_since(self, since: int) -> List[Event]:
        return self.backend.poll_events(int(since))

    @staticmethod
    def _event_json(e: Event) -> Dict[str, Any]:
        return {"etype": int(e.etype), "timestamp": float(e.timestamp),
                "seq": int(e.seq), "chip_index": int(e.chip_index),
                "uuid": e.uuid, "message": e.message}

    # -- ops ------------------------------------------------------------------

    def handle(self, req: Dict[str, Any],
               conn_watches: List[int]) -> Dict[str, Any]:
        self.requests += 1
        op = req.get("op")
        op = op if isinstance(op, str) else ""
        fn = self._OPS.get(op)
        if fn is None:
            return _err(f"unknown op: {op}")
        try:
            return _jsonable(fn(self, req, conn_watches))
        except ChipNotFound:
            return _err("no such chip")
        except (TypeError, ValueError, KeyError, AttributeError) as e:
            return _err(f"bad request: {e}")

    def _hello(self, req, conns) -> Dict[str, Any]:
        v = self.backend.versions()
        r = {"ok": True, "chip_count": self._chips(), "driver": v.driver,
             "runtime": v.runtime, "agent_version": AGENT_VERSION}
        if self.burst is not None:
            st = self.burst.stats()
            r["burst_hz"] = int(st["burst_hz"])
            r["burst_overruns"] = int(st["burst_overruns"])
        return r

    def _chip_info(self, req, conns) -> Dict[str, Any]:
        info = self.backend.chip_info(_int(req.get("index"), -1))
        d: Dict[str, Any] = {
            "uuid": info.uuid, "name": info.name, "arch": info.arch.value,
            "serial": info.serial, "dev_path": info.dev_path,
            "firmware": info.firmware,
            "driver_version": info.driver_version}
        if info.hbm.total and info.hbm.total > 0:
            d["hbm_total_mib"] = info.hbm.total
        if info.clocks_max.tensorcore and info.clocks_max.tensorcore > 0:
            d["tc_clock_mhz"] = info.clocks_max.tensorcore
        if info.clocks_max.hbm and info.clocks_max.hbm > 0:
            d["hbm_clock_mhz"] = info.clocks_max.hbm
        if info.power_limit_w and info.power_limit_w > 0:
            d["power_limit_w"] = float(info.power_limit_w)
        if info.numa_node is not None and info.numa_node >= 0:
            d["numa_node"] = info.numa_node
        d.update(pci_bus_id=info.pci.bus_id, x=info.coords.x,
                 y=info.coords.y, z=info.coords.z, host=socket.gethostname())
        return {"ok": True, "info": d}

    def _check_chip(self, req) -> int:
        idx = _int(req.get("index"), -1)
        if not 0 <= idx < self._chips():
            raise ChipNotFound(f"no such chip {idx}")
        return idx

    def _read_fields(self, req, conns) -> Dict[str, Any]:
        idx = self._check_chip(req)
        fids = [_int(f, -1) for f in req.get("fields") or []]
        self._harvest_if_due()
        values: Dict[str, FieldValue] = {}
        live = [f for f in fids if not self._burst_covers(f)]
        got = self._live({idx: live}).get(idx, {})
        for f in fids:
            values[str(f)] = (self._burst_value(idx, f)
                              if self._burst_covers(f)
                              else wire_value(got.get(f)))
        return {"ok": True, "values": values}

    def _read_fields_bulk(self, req, conns) -> Dict[str, Any]:
        reqs = [(_int(r.get("index"), -1), [_int(f, -1)
                                            for f in r.get("fields") or []])
                for r in req.get("reqs") or []]
        chips, bad = self._sweep(reqs, _max_age(req))
        r: Dict[str, Any] = {
            "ok": True,
            "chips": {str(c): {str(f): v for f, v in vals.items()}
                      for c, vals in chips.items()}}
        if bad:
            r["errors"] = {str(c): "no such chip" for c in bad}
        if req.get("events_since") is not None:
            r["events"] = [self._event_json(e) for e in self._events_since(
                _int(req["events_since"], 0))]
        return r

    def _watch(self, req, conns) -> Dict[str, Any]:
        fields = [_int(f, -1) for f in req.get("fields") or []]
        if not fields:
            return _err("watch requires fields")
        keep = _float(req.get("keep_age_s"), 300.0)
        wm = self.watches
        wid = wm.watch_fields(
            wm.all_chips_group(), wm.create_field_group(fields),
            max(_int(req.get("freq_us"), 1_000_000), 10_000),  # 10 ms floor
            keep if keep > 0 else 300.0)
        wm.start(tick_s=None)
        conns.append(wid)
        return {"ok": True, "watch_id": wid}

    def _unwatch(self, req, conns) -> Dict[str, Any]:
        wid = _int(req.get("watch_id"), -1)
        if not self.watches.unwatch(wid, purge=True):
            return _err("no such watch")
        while wid in conns:
            conns.remove(wid)
        return {"ok": True}

    def _latest(self, req, conns) -> Dict[str, Any]:
        idx = self._check_chip(req)
        values: Dict[str, FieldValue] = {}
        newest = 0.0
        for f in req.get("fields") or []:
            f = _int(f, -1)
            hit = self.watches.latest(idx, f, fresh=True)
            values[str(f)] = None if hit is None else hit.value
            if hit is not None:
                newest = max(newest, hit.timestamp)
        return {"ok": True, "values": values, "ts": newest}

    def _samples(self, req, conns) -> Dict[str, Any]:
        idx = self._check_chip(req)
        got = self.watches.samples_since(idx, _int(req.get("field"), -1),
                                         _float(req.get("since"), 0.0))
        return {"ok": True, "samples": [[ts, v] for ts, v in got]}

    def _topology(self, req, conns) -> Dict[str, Any]:
        t = self.backend.topology(self._check_chip(req))
        d: Dict[str, Any] = {"x": t.coords.x, "y": t.coords.y,
                             "z": t.coords.z}
        if t.numa_node is not None and t.numa_node >= 0:
            d["numa_node"] = t.numa_node
        d.update(cpu_affinity=t.cpu_affinity,
                 mesh_shape=list(t.mesh_shape), wrap=list(t.wrap),
                 links=[{"chip": l.chip_index, "bus_id": l.bus_id,
                         "link": int(l.link), "hops": l.hops}
                        for l in t.links])
        return {"ok": True, "topo": d}

    def _processes(self, req, conns) -> Dict[str, Any]:
        out = []
        for p in self.backend.processes(_int(req.get("index"), -1)):
            d: Dict[str, Any] = {"pid": p.pid, "name": p.name}
            if p.hbm_used_mib is not None:
                d["hbm_used_mib"] = p.hbm_used_mib
            out.append(d)
        return {"ok": True, "processes": out}

    def _events(self, req, conns) -> Dict[str, Any]:
        r: Dict[str, Any] = {"ok": True,
                             "last_seq": self.backend.current_event_seq()}
        if req.get("peek"):
            return r
        r["events"] = [self._event_json(e) for e in self._events_since(
            _int(req.get("since_seq"), 0))]
        return r

    def _introspect(self, req, conns) -> Dict[str, Any]:
        cpu_s, rss_kb = _read_proc_stat(os.getpid())
        uptime = time.time() - self.start_time
        return {"ok": True, "memory_kb": rss_kb,
                "cpu_percent": (100.0 * (cpu_s - self._cpu0) / uptime
                                if uptime > 0 else 0.0),
                "pid": os.getpid(), "uptime_s": uptime,
                "requests": self.requests,
                "samples": (self.samples + self.source.samples
                            + self._burst_samples)}

    def _inject(self, req, conns) -> Dict[str, Any]:
        if not self.allow_inject:
            return _err("event injection disabled")
        inject = getattr(self.backend, "inject_event", None)
        if not callable(inject):
            return _err("source does not support injection")
        try:
            etype = EventType(_int(req.get("etype"), 0))
        except ValueError:
            return _err("unknown event type")
        inject(etype, chip_index=_int(req.get("chip"), 0),
               message=str(req.get("message") or ""))
        return {"ok": True}

    def _term(self, req, conns) -> Dict[str, Any]:
        if self._on_term is not None:
            self._on_term()
        return {"ok": True}

    _OPS = {"hello": _hello, "chip_info": _chip_info,
            "read_fields": _read_fields,
            "read_fields_bulk": _read_fields_bulk, "watch": _watch,
            "unwatch": _unwatch, "latest": _latest, "samples": _samples,
            "topology": _topology, "processes": _processes,
            "events": _events, "introspect": _introspect,
            "inject": _inject, "term": _term}

    # -- sweep_frame ----------------------------------------------------------

    def sweep_frame(self, enc: SweepFrameEncoder,
                    reqs: Sequence[Tuple[int, Sequence[int]]],
                    max_age: Optional[float],
                    events_since: Optional[int]) -> bytes:
        """One delta frame on the connection's encoder (``main.cc``
        ``sweep_frame``): lost or dropped chips purge, events ride along
        when ``events_since`` was sent."""

        self.requests += 1
        chips, _bad = self._sweep(reqs, max_age)
        events = (self._events_since(events_since)
                  if events_since is not None else None)
        return enc.encode_frame(chips, events)

    # -- the Prometheus plane (--prom-port) ------------------------------------

    def _scrape_labels(self, n: int) -> List[Dict[str, str]]:
        """Each chip's labels, read again when the count changes or
        :data:`LABEL_TTL_S` has passed: chip, uuid, model and, with pod
        attribution, the owning pod's."""

        now = time.monotonic()
        if len(self._prom_labels) == n and \
                now - self._prom_labels_t <= LABEL_TTL_S:
            return self._prom_labels
        self._prom_labels_t = now
        mapping = self.pods.device_map() if self.pods is not None else {}
        out = []
        for c in range(n):
            lbl = {"chip": str(c)}
            try:
                info = self.backend.chip_info(c)
            except BackendError:
                info = None
            if info is not None:
                lbl.update(uuid=info.uuid, model=info.name)
            pod = (self.pods.lookup(mapping, lbl.get("uuid", ""), str(c))
                   if mapping else None)
            if pod is not None:
                lbl.update(pod_name=pod.pod, pod_namespace=pod.namespace,
                           container_name=pod.container)
            out.append(lbl)
        self._prom_labels = out
        return out

    def render_prom(self, t_accept: float) -> str:
        """One scrape (``main.cc`` ``render_prom``): the catalog's scrape
        families, numbers only (the burst-derived ones while the burst
        loop runs), then the self-metrics, the merged drop files and the
        scrape's own phases: its wait (``t_accept``, ``time.monotonic``,
        to the lock), collect, formatting and merge, and the previous
        scrape's write.  One scrape at a time."""

        with self._prom_lock:
            t_begin = time.monotonic()
            n = self._chips()
            labels = self._scrape_labels(n)
            fids = SCRAPE_FIELDS + (sorted(
                int(f) for f in FF.EXPORTER_BURST_FIELDS)
                if self.burst is not None else [])
            t_collect = time.monotonic()
            chips, _ = self._sweep([(c, fids) for c in range(n)], None)
            collect_s = time.monotonic() - t_collect
            per_chip = {c: {f: v for f, v in vals.items()
                            if isinstance(v, (int, float, list))}
                        for c, vals in chips.items()}
            cpu_s, rss_kb = _read_proc_stat(os.getpid())
            up = time.time() - self.start_time
            lines = [ln for ln in SweepRenderer(fids).render(
                per_chip, dict(enumerate(labels))).splitlines() if ln]
            lines += render_family(
                "tpumon_agent_cpu_percent", "gauge",
                "Daemon lifetime-average CPU percent.", "",
                100.0 * (cpu_s - self._cpu0) / up if up > 0 else 0.0)
            lines += render_family("tpumon_agent_memory_kb", "gauge",
                                   "Daemon RSS in KB.", "", rss_kb, ".0f")
            lines += render_family("tpumon_agent_uptime_seconds", "gauge",
                                   "Daemon uptime.", "", up, ".1f")
            t_rendered = time.monotonic()
            if self.merge is not None:
                lines = self._merged(lines)
            t_merged = time.monotonic()
            write = [sp for sp in self.spans.last("request")
                     if sp.name == "request.write"]
            phase_ms = ((t_begin - t_accept) * 1e3, collect_s * 1e3,
                        (t_rendered - t_begin - collect_s) * 1e3,
                        (t_merged - t_rendered) * 1e3,
                        write[0].ns / 1e6 if write else 0.0)
            for (fam, help_txt), ms in zip(SCRAPE_PHASES, phase_ms):
                lines += render_family(fam, "gauge", help_txt, "", ms)
            return "\n".join(lines) + "\n"

    def _merged(self, lines: List[str]) -> List[str]:
        """``main.cc`` ``append_merged``: the fresh drop files into the
        scrape, the merge's gauges after the scrape's families; merged
        samples of a family the scrape emits inside its block."""

        series = set(_AGENT_MERGE_FAMILIES)
        decl = set(_AGENT_MERGE_FAMILIES)
        index_lines(lines, series, decl)
        merge = self.merge
        by_family, tail = merge.apply(series, decl, merge.load(time.time()))
        lines = lines + render_family(
            "tpumon_agent_merged_files", "gauge",
            "Fresh textfiles merged into this scrape.", "", merge.files,
            ".0f") + render_family(
            "tpumon_agent_merged_series", "gauge",
            "Sample series merged from textfiles.", "", merge.series, ".0f")
        if by_family:
            lines = splice_lines(lines, by_family)
        return lines + tail

    def health_ok(self) -> bool:
        """``/healthz`` (``main.cc`` ``health_ok``): the source still has
        a device and its first device still answers."""

        try:
            if self._chips() < 1:
                return False
            self.backend.chip_info(0)
        except BackendError:
            return False
        return True

    def close(self) -> None:
        try:
            self.watches.stop()
        finally:
            if self.burst is not None:
                self.burst.stop()


def _err(msg: str) -> Dict[str, Any]:
    return {"ok": False, "error": msg}


def _int(v: Any, default: int) -> int:
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return default
    return int(v)


def _float(v: Any, default: float) -> float:
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return default
    return float(v)


def _max_age(req: Dict[str, Any]) -> Optional[float]:
    v = req.get("max_age_s")
    if v is None or isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    return None if v < 0 else float(v)


def _reply(server: FrameServer, conn: FrameConn, obj: Dict[str, Any]) -> None:
    # JSON replies: the non-sweep ops, and the error answer to a
    # malformed binary request — a well-formed sweep answers a binary
    # frame (Engine.sweep_frame)
    server.send(conn, json.dumps(  # tpumon-lint: disable=json-in-sweep-path
        obj, separators=(",", ":")).encode() + b"\n")


class AgentHandler(ConnHandler):
    """The agent's connections on the frame server: JSON lines to
    :meth:`Engine.handle`, the ``sweep_frame`` probe and binary requests
    to :meth:`Engine.sweep_frame`.  A connection's watches die with it."""

    def __init__(self, engine: Engine) -> None:
        self.engine = engine

    @staticmethod
    def _state(conn: FrameConn) -> Dict[str, Any]:
        if "watches" not in conn.data:
            conn.data["watches"] = []
            conn.data["enc"] = SweepFrameEncoder()
        return conn.data

    def on_json(self, server: FrameServer, conn: FrameConn,
                req: Dict[str, Any]) -> None:
        st = self._state(conn)
        if req.get("op") == "sweep_frame":
            reqs = [(_int(r.get("index"), -1),
                     [_int(f, -1) for f in r.get("fields") or []])
                    for r in req.get("reqs") or [] if isinstance(r, dict)]
            es = req.get("events_since")
            server.send(conn, self.engine.sweep_frame(
                st["enc"], reqs, _max_age(req),
                None if es is None else _int(es, 0)))
            return
        _reply(server, conn, self.engine.handle(req, st["watches"]))

    def on_binary(self, server: FrameServer, conn: FrameConn,
                  payload: bytes) -> None:
        st = self._state(conn)
        try:
            reqs, max_age, events_since = decode_sweep_request(payload)
        except (ValueError, AssertionError, IndexError):
            self.engine.requests += 1
            _reply(server, conn, _err("malformed sweep_frame request"))
            return
        if max_age is not None and max_age < 0:
            max_age = None
        server.send(conn, self.engine.sweep_frame(st["enc"], reqs, max_age,
                                                  events_since))

    def on_text(self, server: FrameServer, conn: FrameConn,
                line: str) -> None:
        self.on_malformed(server, conn, line.encode())

    def on_malformed(self, server: FrameServer, conn: FrameConn,
                     line: bytes) -> None:
        try:
            json.loads(line)
        except ValueError:
            _reply(server, conn, _err("malformed JSON request"))
            return
        # valid JSON that is not an object: a request without an op
        _reply(server, conn, self.engine.handle({}, self._state(conn)
                                                ["watches"]))

    def on_close(self, server: FrameServer, conn: FrameConn) -> None:
        for wid in conn.data.get("watches", ()):
            self.engine.watches.unwatch(wid, purge=True)


def _prom_dispatch(engine: Engine):
    """The agent's HTTP routes: ``/metrics``, ``/healthz``, else 404 (the
    path matched exactly: ``/metricsfoo`` is not ``/metrics``)."""

    ctype = "text/plain; version=0.0.4; charset=utf-8"

    def dispatch(path: str):
        if path == "/metrics":
            # the request's root span starts when accept returned
            req = spans.current()
            return 200, ctype, engine.render_prom(
                (req.root or req).start_ns / 1e9 if req is not None
                else time.monotonic())
        if path == "/healthz":
            if engine.health_ok():
                return 200, ctype, "ok\n"
            return 503, ctype, "metric source unhealthy\n"
        return 404, ctype, "not found\n"

    return dispatch


def open_source(fake: bool, fake_chips: int = 4,
                fake_epoch: float = 0.0,
                kmsg_path: Optional[str] = None) -> Backend:
    """The agent's source, opened: the fake only when asked for, else
    NVML (its Xid watcher on ``kmsg_path``), which must see at least one
    device."""

    if fake:
        b: Backend = AgentFakeBackend(fake_chips, fake_epoch)
        b.open()
        return b
    from .backends.nvml import NvmlBackend

    b = NvmlBackend(kmsg_path=kmsg_path)
    b.open()
    try:
        if b.chip_count() < 1:
            raise LibraryNotFound("NVML sees no device on this host")
    except BaseException:
        b.close()
        raise
    return b


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="tpumon-hostengine", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--domain-socket", metavar="PATH",
                   help=f"serve on a unix socket (default {DEFAULT_SOCKET} "
                        f"when no --port)")
    p.add_argument("--port", type=int, default=0, metavar="N",
                   help="serve on loopback TCP port N")
    p.add_argument("--fake", action="store_true",
                   help="serve the deterministic fake source instead of "
                        "NVML")
    p.add_argument("--fake-chips", type=int, default=4, metavar="N")
    p.add_argument("--fake-epoch", type=float, default=0.0, metavar="T",
                   help="the fake's time origin (unix seconds; 0 = start)")
    p.add_argument("--allow-inject", action="store_true",
                   help="accept the inject op (the fake source only)")
    p.add_argument("--burst-hz", type=int, default=0, metavar="HZ",
                   help="sample the burst sources at HZ into 1 s "
                        "min/max/mean/integral windows (0 = off)")
    p.add_argument("--prom-port", type=int, default=-1, metavar="N",
                   help="serve Prometheus /metrics + /healthz over HTTP "
                        "(0 = kernel-assigned, printed to stderr) straight "
                        "from the agent, no exporter process")
    p.add_argument("--merge-textfile", action="append", default=[],
                   metavar="GLOB",
                   help="merge fresh .prom drop files (a workload's "
                        "self-monitor output) into every scrape; "
                        "repeatable")
    p.add_argument("--merge-max-age", type=float, default=60.0, metavar="S",
                   help="skip merge files older than S seconds (default 60)")
    p.add_argument("--kubelet-socket", default=None, metavar="PATH",
                   help="pod labels by GPU UUID from the kubelet "
                        "pod-resources API on PATH")
    p.add_argument("--pod-resource", default=None, metavar="NAME",
                   help="device-plugin resource to match (default "
                        f"{DEFAULT_RESOURCE})")
    p.add_argument("--kmsg", default=None, metavar="PATH",
                   help="kernel-log stream of the NVML source's Xid "
                        "watcher (default TPUMON_KMSG_PATH or /dev/kmsg)")
    p.add_argument("--v", type=int, default=None, metavar="N",
                   help="log verbosity")
    args = p.parse_args(argv)
    if args.v is not None:
        log.set_verbosity(args.v)

    from .backends.nvml import LibraryAbsent

    try:
        backend = open_source(args.fake, args.fake_chips, args.fake_epoch,
                              args.kmsg)
    except LibraryAbsent as e:
        if not args.merge_textfile:
            print(f"tpumon-hostengine: no metric source: {e}; use --fake "
                  f"for the simulated source, or --merge-textfile for "
                  f"merge-only mode", file=sys.stderr)
            return 3
        # merge-only mode: no NVML on this host, but drop files to serve
        # (a library that loads and fails still exits, never masked)
        backend = EmptySource()
        log.info("tpumon-hostengine: no NVML (%s); merge-only mode", e)
    except (LibraryNotFound, BackendError) as e:
        print(f"tpumon-hostengine: no metric source: {e}", file=sys.stderr)
        return 3
    stop = threading.Event()
    engine = server = prom = None
    try:
        pods = None
        if args.kubelet_socket:
            from .exporter.pod_attrib import PodAttributor
            pods = PodAttributor(socket_path=args.kubelet_socket,
                                 resource=args.pod_resource)
        engine = Engine(backend, allow_inject=args.allow_inject,
                        burst_hz=args.burst_hz, on_term=stop.set,
                        merge=(TextfileMerge(args.merge_textfile,
                                             args.merge_max_age)
                               if args.merge_textfile else None),
                        pods=pods)
        server = FrameServer()
        handler = AgentHandler(engine)
        if args.domain_socket or not args.port:
            path = args.domain_socket or DEFAULT_SOCKET
            if os.path.exists(path):
                os.unlink(path)  # a killed predecessor's socket file
            address = server.add_unix_listener(handler, path)
        else:
            address = server.add_tcp_listener(handler, "127.0.0.1",
                                              args.port)
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
        signal.signal(signal.SIGINT, lambda *_: stop.set())
        server.start()
        if args.prom_port >= 0:
            prom = TextHTTPServer(_prom_dispatch(engine), args.prom_port,
                                  spans=engine.spans)
            prom.start()
            print(f"tpumon-hostengine: serving /metrics on port "
                  f"{prom.port}", file=sys.stderr, flush=True)
        log.info("tpumon-hostengine: %s source, %d device(s), serving on "
                 "%s", "fake" if args.fake else "nvml",
                 backend.chip_count(), address)
        stop.wait()
    finally:
        if prom is not None:
            prom.stop()
        if server is not None:
            server.close()
        try:
            if engine is not None:
                engine.close()
        finally:
            backend.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
