"""Pod-attribution: splice pod/namespace/container labels into sweeps.

The port's copy of ``tpumon/exporter/pod_attrib.py``.  Analog of the
original's enrichment loop (``device_pod.go:57-113``): for each metric
sample line, parse the ``uuid`` and ``chip`` labels, look up the owning
pod by device UUID — NVML's ``GPU-…`` string, which is also the device ID
NVIDIA's device plugin hands the kubelet — and then by the index
conventions: ``nvidia<index>`` (the run.ai device-plugin convention,
``device_pod.go:96-99``) and bare ``<index>``; then splice
``pod_name/pod_namespace/container_name`` before the closing ``}``.  The
reference's ``tpu-<index>`` / ``tpu<index>`` keys are not looked up here.

Device map sources:
* :func:`tpumon_torch.exporter.podresources.list_pod_resources` — the
  kubelet gRPC socket, filtered to ``nvidia.com/gpu`` (overridable);
* a JSON file (``TPUMON_POD_MAP_FILE``) mapping device-id -> {pod,
  namespace, container} for environments without a kubelet.

The map is cached and refreshed at most once per second (the kubelet call
is per-sweep in the reference because sweeps are 1 Hz; we keep that bound
explicit).
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Dict, Mapping, Optional

from .. import log

from .podresources import (DEFAULT_RESOURCE, DEFAULT_SOCKET, PodInfo,
                           list_pod_resources)

_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


class PodAttributor:
    def __init__(self, socket_path: Optional[str] = None,
                 resource: Optional[str] = None,
                 map_file: Optional[str] = None,
                 refresh_s: float = 1.0) -> None:
        self.socket_path = socket_path or DEFAULT_SOCKET
        self.resource = resource or os.environ.get("TPUMON_POD_RESOURCE",
                                                   DEFAULT_RESOURCE)
        self.map_file = map_file or os.environ.get("TPUMON_POD_MAP_FILE")
        self.refresh_s = refresh_s
        self._cache: Dict[str, PodInfo] = {}
        self._cache_ts = 0.0

    # -- device map ----------------------------------------------------------

    def device_map(self) -> Dict[str, PodInfo]:
        now = time.monotonic()
        if now - self._cache_ts < self.refresh_s and self._cache:
            return self._cache
        mapping: Dict[str, PodInfo] = {}
        if self.map_file:
            try:
                with open(self.map_file) as f:
                    raw = json.load(f)
                for dev, d in raw.items():
                    mapping[str(dev)] = PodInfo(
                        pod=str(d.get("pod", "")),
                        namespace=str(d.get("namespace", "")),
                        container=str(d.get("container", "")))
            except (OSError, ValueError, AttributeError, TypeError) as e:
                # unreadable or wrong-shaped map (e.g. a non-atomic
                # rewrite in flight): keep the PREVIOUS map — same
                # labels-must-not-flap invariant as the kubelet branch
                log.warn_every("pod_attrib.mapfile", 60.0,
                               "pod map file %s unreadable; keeping "
                               "previous map: %r", self.map_file, e)
                mapping = self._cache
        else:
            try:
                devices, resources = list_pod_resources(self.socket_path)
                mapping = {dev: info for dev, info in devices.items()
                           if resources.get(dev, "") == self.resource}
            except Exception as e:
                # kubelet unreachable: keep serving the PREVIOUS map — a
                # kubelet restart must not strip pod labels mid-flight
                # (same invariant as the native daemon's refresher);
                # visible via rate-limited WARN (glog in the reference
                # pod exporter, src/main.go:18-33)
                log.warn_every("pod_attrib.kubelet", 60.0,
                               "kubelet pod-resources query failed "
                               "(%s); keeping previous map: %r",
                               self.socket_path, e)
                mapping = self._cache
        self._cache = mapping
        self._cache_ts = now
        return mapping

    # -- line rewriting (device_pod.go:57-113 analog) -------------------------

    def lookup(self, mapping: Mapping[str, PodInfo], uuid: str,
               chip: str) -> Optional[PodInfo]:
        """Resolve a chip to its pod by uuid or the index-based
        device-plugin ID conventions — the public contract that
        TpuExporter.set_pod_attributor builds on."""

        return self._lookup(mapping, uuid, chip)

    def _lookup(self, mapping: Mapping[str, PodInfo], uuid: str,
                chip: str) -> Optional[PodInfo]:
        if uuid in mapping:
            return mapping[uuid]
        # index-based device-plugin ID conventions
        for key in (f"nvidia{chip}", chip):
            if key in mapping:
                return mapping[key]
        return None

    def enrich(self, text: str) -> str:
        mapping = self.device_map()
        if not mapping:
            return text
        out = []
        for line in text.split("\n"):
            if not line or line.startswith("#") or "{" not in line:
                out.append(line)
                continue
            labels = dict(_LABEL_RE.findall(line.split("}", 1)[0]))
            info = self._lookup(mapping, labels.get("uuid", ""),
                                labels.get("chip", ""))
            if info is None:
                out.append(line)
                continue
            splice = (f',pod_name="{info.pod}"'
                      f',pod_namespace="{info.namespace}"'
                      f',container_name="{info.container}"')
            out.append(line.replace("}", splice + "}", 1))
        return "\n".join(out)
