"""REST API route table + handlers.

The port's copy of ``tpumon/restapi/server.py``, imports renamed, over the
port's façade (the NVML backend by default) and its text renderers
(``cli.deviceinfo``, ``cli.processinfo``); never imports torch.

Route table mirrors ``samples/dcgm/restApi/server.go:40-71`` with a ``tpu``
prefix; every text route has a ``/json`` twin dispatched the same way
(``handlers/byIds.go:7-65``, ``handlers/utils.go:149-172``):

    GET /tpu/device/info/{id}                 /tpu/device/info/json/{id}
    GET /tpu/device/info/uuid/{uuid}          /tpu/device/info/json/uuid/{uuid}
    GET /tpu/device/status/{id}               /tpu/device/status/json/{id}
    GET /tpu/device/status/uuid/{uuid}        /tpu/device/status/json/uuid/{uuid}
    GET /tpu/device/topology/{id}             /tpu/device/topology/json/{id}
    GET /tpu/process/info/pid/{pid}           /tpu/process/info/json/pid/{pid}
    GET /tpu/health/{id}                      /tpu/health/json/{id}
    GET /tpu/health/uuid/{uuid}               /tpu/health/json/uuid/{uuid}
    GET /tpu/status                           /tpu/status/json

Validation follows ``handlers/utils.go:115-147`` (isValidId/isSupported ->
400/404 with plain-text reasons).  The UUID->id map is built once at
startup (``handlers/byUuids.go:13-29``).  The process endpoint enables PID
watches and warms up before reading — the 3 s sleep semantic of
``handlers/dcgm.go:127-129`` (configurable for tests).
"""

from __future__ import annotations

import dataclasses
import enum
import json
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import tpumon_torch
from ..cli.common import fmt
from ..cli.deviceinfo import render as render_deviceinfo
from ..cli.processinfo import render as render_processinfo
from ..httputil import TextHTTPServer


def _to_jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _to_jsonable(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.name
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(x) for x in obj]
    if isinstance(obj, dict):
        return {str(k): _to_jsonable(v) for k, v in obj.items()}
    return obj


STATUS_TEMPLATE = """\
---------- Monitor Status ----------
Engine                 : {engine}
PID                    : {pid}
Memory (KB)            : {mem:.0f}
CPU (%)                : {cpu:.3f}
Uptime (s)             : {uptime:.1f}
Samples/sec            : {sps:.1f}
Chips                  : {chips}
"""

STATUS_CHIP_TEMPLATE = """\
---------- Chip {index} Status ----------
Power (W)              : {power}
Core Temp (C)          : {temp}
HBM Temp (C)           : {hbm_temp}
TensorCore Util (%)    : {tc}
HBM BW Util (%)        : {hbm_bw}
Infeed/Outfeed (%)     : {infeed} / {outfeed}
HBM Used/Total (MiB)   : {used} / {total}
Clocks TC/HBM (MHz)    : {tcclk} / {hbmclk}
ECC SBE/DBE            : {sbe} / {dbe}
PCIe tx/rx (MB/s)      : {tx} / {rx}
ICI tx/rx (MB/s)       : {icitx} / {icirx}
ICI Links Up           : {links}
Throttle               : {throttle}
Processes              : {procs}
"""

HEALTH_TEMPLATE = """\
---------- Chip {index} Health ----------
Overall                : {overall}
{incidents}"""


class RestApi:
    def __init__(self, handle: "tpumon_torch.Handle",
                 process_warmup_s: float = 3.0) -> None:
        self.h = handle
        self.process_warmup_s = process_warmup_s
        # UUID -> id map built once at startup (byUuids.go:13-29)
        self.uuid_map: Dict[str, int] = {}
        for i in handle.supported_chips():
            self.uuid_map[handle.chip_info(i).uuid] = i
        self._pid_watch_enabled = False
        self._lock = threading.Lock()
        #: set once the first caller's pid-watch warm-up finished (or
        #: failed); later callers wait on it with a bounded deadline
        self._pid_warm = threading.Event()
        # (regex, handler(match) -> (payload, is_error)) table
        self.routes: List[Tuple[re.Pattern[str], bool,
                                Callable[[re.Match[str], bool],
                                         Tuple[int, Any]]]] = []
        for pattern, fn in [
            (r"/tpu/device/info/json/uuid/(?P<uuid>[^/]+)/?", self._info),
            (r"/tpu/device/info/json/(?P<id>[^/]+)/?", self._info),
            (r"/tpu/device/info/uuid/(?P<uuid>[^/]+)/?", self._info),
            (r"/tpu/device/info/(?P<id>[^/]+)/?", self._info),
            (r"/tpu/device/status/json/uuid/(?P<uuid>[^/]+)/?", self._status),
            (r"/tpu/device/status/json/(?P<id>[^/]+)/?", self._status),
            (r"/tpu/device/status/uuid/(?P<uuid>[^/]+)/?", self._status),
            (r"/tpu/device/status/(?P<id>[^/]+)/?", self._status),
            (r"/tpu/device/topology/json/(?P<id>[^/]+)/?", self._topology),
            (r"/tpu/device/topology/(?P<id>[^/]+)/?", self._topology),
            (r"/tpu/process/info/json/pid/(?P<pid>[^/]+)/?", self._process),
            (r"/tpu/process/info/pid/(?P<pid>[^/]+)/?", self._process),
            (r"/tpu/health/json/uuid/(?P<uuid>[^/]+)/?", self._health),
            (r"/tpu/health/json/(?P<id>[^/]+)/?", self._health),
            (r"/tpu/health/uuid/(?P<uuid>[^/]+)/?", self._health),
            (r"/tpu/health/(?P<id>[^/]+)/?", self._health),
            (r"/tpu/status/json/?", self._engine_status),
            (r"/tpu/status/?", self._engine_status),
        ]:
            self.routes.append((re.compile("^" + pattern + "$"),
                                "/json" in pattern, fn))

    # -- validation (handlers/utils.go:115-147 analog) ------------------------

    def _resolve(self, m: re.Match[str]) -> Tuple[Optional[int],
                                                  Optional[Tuple[int, str]]]:
        gd = m.groupdict()
        if "uuid" in gd and gd["uuid"] is not None:
            uuid = gd["uuid"]
            if uuid not in self.uuid_map:
                return None, (404, f"unknown uuid: {uuid}")
            return self.uuid_map[uuid], None
        raw = gd.get("id", "")
        if not raw.isdigit():
            return None, (400, f"invalid id: {raw!r} (must be a "
                               f"non-negative integer)")
        idx = int(raw)
        if idx not in self.h.supported_chips():
            return None, (404, f"no such chip: {idx}")
        return idx, None

    # -- handlers --------------------------------------------------------------

    def _info(self, m: re.Match[str], as_json: bool) -> Tuple[int, Any]:
        idx, err = self._resolve(m)
        if err is not None:
            return err
        assert idx is not None  # _resolve yields exactly one of the pair
        if as_json:
            return 200, _to_jsonable(self.h.chip_info(idx))
        return 200, render_deviceinfo(self.h, idx)

    def _status(self, m: re.Match[str], as_json: bool) -> Tuple[int, Any]:
        idx, err = self._resolve(m)
        if err is not None:
            return err
        assert idx is not None  # _resolve yields exactly one of the pair
        st = self.h.chip_status(idx)
        if as_json:
            return 200, _to_jsonable(st)
        f = fmt
        return 200, STATUS_CHIP_TEMPLATE.format(
            index=idx, power=f(st.power_w), temp=f(st.core_temp_c),
            hbm_temp=f(st.hbm_temp_c), tc=f(st.utilization.tensorcore),
            hbm_bw=f(st.utilization.hbm_bw),
            infeed=f(st.utilization.infeed), outfeed=f(st.utilization.outfeed),
            used=f(st.memory.used), total=f(st.memory.total),
            tcclk=f(st.clocks.tensorcore), hbmclk=f(st.clocks.hbm),
            sbe=f(st.ecc.sbe_volatile), dbe=f(st.ecc.dbe_volatile),
            tx=f(st.host_link.tx), rx=f(st.host_link.rx),
            icitx=f(st.ici.tx), icirx=f(st.ici.rx),
            links=f(st.ici.links_up), throttle=st.throttle.name,
            procs=", ".join(f"{p.pid}({p.name})" for p in st.processes) or "-",
        )

    def _topology(self, m: re.Match[str],
                  as_json: bool) -> Tuple[int, Any]:
        idx, err = self._resolve(m)
        if err is not None:
            return err
        assert idx is not None  # _resolve yields exactly one of the pair
        topo = self.h.topology(idx)
        if as_json:
            return 200, _to_jsonable(topo)
        lines = [f"---------- Chip {idx} Topology ----------",
                 f"Coords                 : ({topo.coords.x},{topo.coords.y},"
                 f"{topo.coords.z}) slice {topo.coords.slice_index}",
                 f"Mesh                   : "
                 f"{'x'.join(map(str, topo.mesh_shape)) or '-'}",
                 f"CPU Affinity           : {topo.cpu_affinity or '-'}",
                 f"NUMA Node              : {topo.numa_node if topo.numa_node is not None else '-'}"]
        for l in topo.links:
            lines.append(f"  -> chip {l.chip_index}: {l.link.name} "
                         f"({l.hops} hop{'s' if l.hops != 1 else ''})")
        return 200, "\n".join(lines) + "\n"

    def _process(self, m: re.Match[str], as_json: bool) -> Tuple[int, Any]:
        raw = m.group("pid")
        if not raw.isdigit():
            return 400, f"invalid pid: {raw!r}"
        pid = int(raw)
        # enable watches on first use, then warm up (dcgm.go:127-129).
        # The lock covers ONLY the once-latch: the warm-up loop sweeps
        # and sleeps for up to process_warmup_s, and holding the lock
        # across it (the pre-tpumon-check shape) meant one stuck
        # warm-up sweep parked every later process request on the lock
        # UNBOUNDEDLY (tpumon-check: blocking-while-locked).  Now the
        # first caller warms up outside the lock and signals _pid_warm;
        # concurrent callers wait for that signal with a bounded
        # deadline instead of queueing on the lock.
        with self._lock:
            first = not self._pid_watch_enabled
            if first:
                self._pid_watch_enabled = True
        if first:
            enabled = False
            try:
                self.h.watch_pid_fields(None)
                enabled = True
                deadline = time.monotonic() + self.process_warmup_s
                while time.monotonic() < deadline:
                    self.h.watches.update_all(wait=True)
                    time.sleep(min(0.2, self.process_warmup_s / 4))
            finally:
                if enabled:
                    # warm-up trouble after a successful enable keeps
                    # the latch (the watches exist; this request just
                    # 500s) — but a FAILED enable must clear it so the
                    # next request retries instead of serving empty
                    # process data forever
                    self._pid_warm.set()
                else:
                    with self._lock:
                        self._pid_watch_enabled = False
                        # wake anyone already waiting (their attempt
                        # concluded — no point sitting out the full
                        # bounded wait), then arm a fresh event so the
                        # NEXT enable attempt gets its own signal
                        self._pid_warm.set()
                        self._pid_warm = threading.Event()
        else:
            # bounded: a wedged first warm-up must degrade THIS reply
            # to possibly-empty data, never block the API forever
            self._pid_warm.wait(self.process_warmup_s + 1.0)
        info = self.h.get_process_info(pid)
        if not info.chip_indices:
            return 404, f"pid {pid} holds no TPU chip"
        if as_json:
            return 200, _to_jsonable(info)
        return 200, render_processinfo(info)

    def _health(self, m: re.Match[str], as_json: bool) -> Tuple[int, Any]:
        idx, err = self._resolve(m)
        if err is not None:
            return err
        assert idx is not None  # _resolve yields exactly one of the pair
        res = self.h.health_check(idx)
        if as_json:
            return 200, _to_jsonable(res)
        incidents = "".join(
            f"  [{i.status.name}] {i.system.name}: {i.message}\n"
            for i in res.incidents)
        return 200, HEALTH_TEMPLATE.format(index=idx,
                                           overall=res.status.name,
                                           incidents=incidents)

    def _engine_status(self, m: re.Match[str],
                       as_json: bool) -> Tuple[int, Any]:
        st = self.h.introspect()
        # the port has no agent backend yet (ROADMAP.md, Queue 1, item
        # 16b, part 5): every engine is the embedded one
        engine = "embedded"
        if as_json:
            d = _to_jsonable(st)
            d["engine"] = engine
            d["chips"] = len(self.h.supported_chips())
            return 200, d
        return 200, STATUS_TEMPLATE.format(
            engine=engine, pid=st.pid, mem=st.memory_kb, cpu=st.cpu_percent,
            uptime=st.uptime_s, sps=st.samples_per_second,
            chips=len(self.h.supported_chips()))

    # -- dispatch --------------------------------------------------------------

    def dispatch(self, path: str) -> Tuple[int, str, str]:
        """Returns (http_status, content_type, body)."""

        for pattern, as_json, fn in self.routes:
            m = pattern.match(path)
            if not m:
                continue
            code, payload = fn(m, as_json)
            if code != 200:
                return code, "text/plain; charset=utf-8", str(payload) + "\n"
            if as_json:
                return 200, "application/json", json.dumps(payload) + "\n"
            return 200, "text/plain; charset=utf-8", payload
        return (404, "text/plain; charset=utf-8",
                f"no route for {path}\n")


class RestApiServer(TextHTTPServer):
    def __init__(self, api: RestApi, port: int = 8070, bind: str = "") -> None:
        super().__init__(api.dispatch, port=port, bind=bind)
