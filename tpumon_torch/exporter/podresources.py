"""kubelet pod-resources client (device -> pod attribution source).

The port's copy of ``tpumon/exporter/podresources.py``: the one change is
the default resource filter, ``nvidia.com/gpu``.

Analog of the reference's ``kubelet_server.go:20-53``: gRPC over the unix
socket ``/var/lib/kubelet/pod-resources/kubelet.sock``, calling
``v1alpha1.PodResources/List`` with a 16 MB message cap and 10 s timeout.

The podresources v1alpha1 schema is tiny, so instead of vendoring generated
protobuf stubs (the reference vendors the whole k8s client,
``vendor.conf:1-10``) we ship a ~60-line wire codec for exactly these
messages:

    ListPodResourcesRequest  {}
    ListPodResourcesResponse { repeated PodResources pod_resources = 1; }
    PodResources             { string name = 1; string namespace = 2;
                               repeated ContainerResources containers = 3; }
    ContainerResources       { string name = 1;
                               repeated ContainerDevices devices = 2; }
    ContainerDevices         { string resource_name = 1;
                               repeated string device_ids = 2; }

The transport is the stdlib-only minimal HTTP/2 client
(:mod:`.grpc_min`) by default, with the grpc package as an opt-in
fallback (``TPUMON_GRPC_TRANSPORT=grpcio``); no generated code, no
protoc at build time, no heavyweight imports on the 1 Hz data plane.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

DEFAULT_SOCKET = "/var/lib/kubelet/pod-resources/kubelet.sock"
#: the resource NVIDIA's device plugin advertises, the original's own
#: filter (device_pod.go:17,32); ``TPUMON_POD_RESOURCE`` overrides it
DEFAULT_RESOURCE = "nvidia.com/gpu"
MAX_MSG_BYTES = 16 * 1024 * 1024     # kubelet_server.go:16
TIMEOUT_S = 10.0                     # kubelet_server.go:17-18


@dataclass(frozen=True)
class PodInfo:
    pod: str
    namespace: str
    container: str


# ---- minimal protobuf wire codec --------------------------------------------
# decoding rides the shared wire walker (tpumon_torch/wire.py) so
# low-level varint/framing behavior cannot drift between hand-rolled
# codecs

from ..wire import iter_fields as _iter_fields  # noqa: E402


def parse_list_response(data: bytes) -> Tuple[Dict[str, PodInfo],
                                              Dict[str, str]]:
    """ListPodResourcesResponse -> ({device_id: PodInfo},
    {device_id: resource_name}); the caller filters by resource name."""

    devices: Dict[str, PodInfo] = {}
    resources: Dict[str, str] = {}
    for fno, wire, payload in _iter_fields(data):
        if fno != 1 or wire != 2:
            continue
        pod_name = namespace = ""
        containers: List[bytes] = []
        for pfno, pwire, ppay in _iter_fields(payload):
            if pfno == 1 and pwire == 2:
                pod_name = ppay.decode("utf-8", "replace")
            elif pfno == 2 and pwire == 2:
                namespace = ppay.decode("utf-8", "replace")
            elif pfno == 3 and pwire == 2:
                containers.append(ppay)
        for cpay in containers:
            container_name = ""
            dev_blocks: List[bytes] = []
            for cfno, cwire, cp in _iter_fields(cpay):
                if cfno == 1 and cwire == 2:
                    container_name = cp.decode("utf-8", "replace")
                elif cfno == 2 and cwire == 2:
                    dev_blocks.append(cp)
            for dpay in dev_blocks:
                resource_name = ""
                ids: List[str] = []
                for dfno, dwire, dp in _iter_fields(dpay):
                    if dfno == 1 and dwire == 2:
                        resource_name = dp.decode("utf-8", "replace")
                    elif dfno == 2 and dwire == 2:
                        ids.append(dp.decode("utf-8", "replace"))
                info = PodInfo(pod=pod_name, namespace=namespace,
                               container=container_name)
                for dev_id in ids:
                    devices[dev_id] = info
                    resources[dev_id] = resource_name
    return devices, resources


def encode_pod_resources(pods) -> bytes:
    """Encode a ListPodResourcesResponse (server-side helper for tests).

    ``pods``: list of (name, namespace, [(container, resource, [ids])...]).
    """

    def ld(field_no: int, payload: bytes) -> bytes:
        return bytes([(field_no << 3) | 2]) + _varint(len(payload)) + payload

    def _varint(n: int) -> bytes:
        out = bytearray()
        while True:
            b = n & 0x7F
            n >>= 7
            out.append(b | (0x80 if n else 0))
            if not n:
                return bytes(out)

    msg = b""
    for name, namespace, containers in pods:
        pod_payload = ld(1, name.encode()) + ld(2, namespace.encode())
        for cname, resource, ids in containers:
            dev = ld(1, resource.encode())
            for i in ids:
                dev += ld(2, i.encode())
            pod_payload += ld(3, ld(1, cname.encode()) + ld(2, dev))
        msg += ld(1, pod_payload)
    return msg


def list_pod_resources(socket_path: str = DEFAULT_SOCKET,
                       timeout_s: float = TIMEOUT_S,
                       ) -> Tuple[Dict[str, PodInfo], Dict[str, str]]:
    """Call PodResources/List; returns ({device_id: PodInfo},
    {device_id: resource_name}).  Raises OSError/RuntimeError on failure.

    Transport is the stdlib-only minimal client (:mod:`.grpc_min`) by
    default — it keeps ~14 MB of grpc package out of the exporter's RSS
    budget (k8s node-exporter limit is 50 MiB,
    gpu-node-exporter-daemonset.yaml:32-34).  Set
    ``TPUMON_GRPC_TRANSPORT=grpcio`` to use the full grpc package
    instead (e.g. if a kubelet speaks HTTP/2 in a way the minimal client
    doesn't)."""

    import os
    if os.environ.get("TPUMON_GRPC_TRANSPORT") == "grpcio":
        import grpc

        channel = grpc.insecure_channel(
            f"unix://{socket_path}",
            options=[("grpc.max_receive_message_length", MAX_MSG_BYTES)])
        try:
            call = channel.unary_unary(
                "/v1alpha1.PodResources/List",
                request_serializer=lambda _: b"",
                response_deserializer=lambda b: b)
            raw = call(None, timeout=timeout_s)
            return parse_list_response(raw)
        finally:
            channel.close()

    from .grpc_min import unary_call
    raw = unary_call(socket_path, "/v1alpha1.PodResources/List", b"",
                     timeout_s=timeout_s)
    return parse_list_response(raw)
