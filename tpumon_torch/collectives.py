"""Collective wire-byte attribution: a measured NVLink lower bound.

Counterpart of ``tpumon/collectives.py``.  A profiler capture records
every collective a ``torch.distributed`` process group ran, and standard
ring algorithms give an exact lower bound for the bytes each rank moved
over its links:

=================  ==========================  =========================
op                 per-rank wire bytes          note
=================  ==========================  =========================
all-reduce         ``2 * S * (n-1)/n``          ring reduce-scatter +
                                                all-gather; S = tensor
all-gather         ``S_out * (n-1)/n``          S_out = gathered result
reduce-scatter     ``S_in * (n-1)/n``           S_in = unscattered input
all-to-all         ``S * (n-1)/n``              each rank keeps 1/n
broadcast, send    ``S``                        one copy over the wire
recv               ``0``                        the rx half of a send
=================  ==========================  =========================

``n`` is the group size; ``n == 1`` moves nothing, and an unknown ``n``
degrades to the factor 1.0, still a lower bound.  A recv counts nothing:
the bytes are its sender's transmission, as the reference counts a
collective-permute once, and ring traffic is symmetric (tx == rx).

**Where the events come from.**  The reference parses compiled HLO; here
the backend's own host events are read (:func:`comm_records`).  Each
collective a process group runs is one event named ``<backend>:<op>``:
``gloo:all_reduce``, ``gloo:all_gather``, ``gloo:all_to_all``,
``gloo:send``, ``gloo:recv`` on gloo's worker threads, ``nccl:<op>`` on
the calling thread.  With ``record_shapes`` the event carries its
tensors' dims and types, which give ``S``.  The event names the op the
backend RAN, which is what is attributed: gloo runs
``reduce_scatter_tensor`` as ``gloo:all_reduce`` over the whole input
(then copies the rank's shard out), so on gloo a reduce-scatter counts as
an all-reduce of its input, ``2 * S_in * (n-1)/n``, twice what NCCL's
ring reduce-scatter moves.  gloo's ``gloo:all_gather`` records only the
rank's shard, so ``S_out`` is the shard times ``n``.

**The group size.**  The events carry none on gloo (torch 2.13), so ``n``
comes from the group the workload declared around the call with
:func:`group_scope`: a ``record_function`` named
``tpumon.group[n=<size>,dcn=<0|1>]``, on the calling thread, whose window
holds the backend event's start (a synchronous collective runs inside
the call).  That is the analog of the reference's participant and slice
maps (``tpumon/xplane.py:1526-1650``): ``dcn=1`` marks a group whose
members sit in different slices, and its bytes are the DCN share
(:func:`split_bytes`, the counterpart of ``module_wire_bytes_split``).
NCCL's process group records each collective's parameters too, as a
``record_param_comms`` event enclosing its ``nccl:<op>`` event (torch 2.11
on an H100), whose last argument is the group size: where there is one,
it outranks the scope.  NCCL's kernels appear on the device under the
op's name as well; only the host events count.
"""

from __future__ import annotations

import re
from typing import Iterable, List, NamedTuple, Optional, Tuple

#: the profiler's names of tensor element types -> bytes
_DTYPE_BYTES = {
    "bool": 1, "signed char": 1, "unsigned char": 1, "c10::Float8_e4m3fn": 1,
    "c10::Float8_e5m2": 1, "short int": 2, "c10::Half": 2,
    "c10::BFloat16": 2, "int": 4, "unsigned int": 4, "float": 4,
    "long int": 8, "long long int": 8, "double": 8,
    "c10::complex<float>": 8, "c10::complex<double>": 16,
}

#: op name fragments -> kind, longest match first ("all-reduce-scatter"
#: never mismatches); names are normalised to dashes
_KINDS = (
    ("reduce-scatter", "scatter"),
    ("all-reduce", "allreduce"),
    ("allreduce", "allreduce"),
    ("all-gather", "gather"),
    ("allgather", "gather"),
    ("all-to-all", "alltoall"),
    ("alltoall", "alltoall"),
    ("broadcast", "permute"),
    ("send", "p2p"),
    ("recv", "recv"),
)

#: a backend's record of one collective it ran
_BACKEND_RE = re.compile(r"^(gloo|nccl|ucc|mpi):(\w+)$")
#: the workload's group declaration (see :func:`group_scope`)
SCOPE_PREFIX = "tpumon.group"
_SCOPE_RE = re.compile(r"^tpumon\.group\[n=(\d+),dcn=([01])\]$")
#: the NCCL process group's parameter record
PARAM_COMMS = "record_param_comms"


def group_scope(size: int, crosses_slices: bool = False):
    """A ``record_function`` that declares the group of the collectives
    called inside it: its size and whether its members sit in different
    slices.  Cheap when no profiler is recording."""

    from torch.profiler import record_function

    return record_function(
        f"{SCOPE_PREFIX}[n={int(size)},dcn={int(bool(crosses_slices))}]")


def collective_kind(name: str) -> Optional[str]:
    """Kind key of an op name (``all_reduce``, ``_reduce_scatter_base``,
    ``send``...), or None for a non-collective."""

    p = name.lower().strip("_").replace("_", "-")
    for frag, kind in _KINDS:
        if frag in p:
            return kind
    return None


def wire_bytes(kind: str, size: int, n: Optional[int]) -> int:
    """Per-rank wire bytes for ONE execution of a collective of ``kind``
    over ``size`` payload bytes (the table above) in a group of ``n``
    (None: unknown, factor 1.0)."""

    if size <= 0 or kind == "recv":
        return 0
    if kind == "allreduce":
        factor = 1.0 if n is None else (2.0 * (n - 1) / n if n > 1 else 0.0)
    elif kind in ("gather", "scatter", "alltoall"):
        factor = 1.0 if n is None else ((n - 1) / n if n > 1 else 0.0)
    else:  # permute / p2p: the payload goes over the wire once
        factor = 1.0
    return int(size * factor)


def tensor_bytes(dims, dtype: str) -> int:
    """Bytes of one recorded tensor (0 for a non-tensor argument or an
    unknown element type)."""

    elem = _DTYPE_BYTES.get(dtype)
    if elem is None or not isinstance(dims, (list, tuple)):
        return 0
    n = elem
    for d in dims:
        n *= int(d)
    return n


def payload_bytes(kind: str, sizes: List[int], n: Optional[int]) -> int:
    """``S`` of the table from the event's recorded tensor sizes: the
    largest tensor (the unscattered input, the gathered output); an
    all-gather that recorded only its shard gathers ``n`` of them."""

    if not sizes:
        return 0
    if kind == "gather" and len(sizes) == 1 and n:
        return sizes[0] * n
    return max(sizes)


class CommRecord(NamedTuple):
    """One collective a backend ran, attributed."""

    kind: str
    #: ``S``: the payload the formula is applied to
    payload: int
    #: group size (None: unknown)
    n: Optional[int]
    #: the group crosses slices (its bytes are DCN)
    dcn: bool
    #: the backend event's host interval
    start_ns: int
    end_ns: int
    #: :func:`wire_bytes` of the above
    wire: int


def _param_group_size(e) -> Optional[int]:
    """The group size a ``record_param_comms`` event records: its last
    argument (after the group's first global rank and rank stride), which
    ``record_shapes`` keeps among its concrete inputs (torch 2.11 with
    NCCL on an H100: ``[..., 0, 1, 1]`` at one rank)."""

    args = e.concrete_inputs()
    if len(args) >= 3 and all(isinstance(v, int) and not isinstance(v, bool)
                              for v in args[-3:]) and args[-1] > 0:
        return args[-1]
    return None


def _enclosing(windows: List[Tuple[int, int, object]], t: int):
    """Value of the innermost (latest-starting) window holding ``t``."""

    best = None
    for s, e, v in windows:
        if s <= t <= e and (best is None or s >= best[0]):
            best = (s, v)
    return None if best is None else best[1]


def comm_records(events: Iterable) -> List[CommRecord]:
    """The collectives of one capture's ``KinetoEvent`` list, each with
    its kind, payload, group and wire bytes (module docstring)."""

    from torch.autograd import DeviceType

    scopes: List[Tuple[int, int, object]] = []
    params: List[Tuple[int, int, object]] = []
    backend = []
    for e in events:
        if e.device_type() != DeviceType.CPU:
            continue  # NCCL's kernels carry the op's name on the device
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        m = _SCOPE_RE.match(name)
        if m:
            scopes.append((start, end, (int(m.group(1)),
                                        m.group(2) == "1")))
            continue
        if name == PARAM_COMMS:
            n = _param_group_size(e)
            if n is not None:
                params.append((start, end, n))
            continue
        m = _BACKEND_RE.match(name)
        if m:
            kind = collective_kind(m.group(2))
            if kind is not None:
                sizes = [tensor_bytes(d, t)
                         for d, t in zip(e.shapes(), e.dtypes())]
                backend.append((kind, [s for s in sizes if s > 0], start,
                                end))
    out: List[CommRecord] = []
    for kind, sizes, start, end in backend:
        scope = _enclosing(scopes, start)
        n, dcn = scope if scope is not None else (None, False)
        pn = _enclosing(params, start)
        if pn is not None:
            n = pn
        size = payload_bytes(kind, sizes, n)
        out.append(CommRecord(kind, size, n, dcn, start, end,
                              wire_bytes(kind, size, n)))
    return out


def split_bytes(comms: Iterable[CommRecord]) -> Tuple[int, int]:
    """Per-rank (ici_bytes, dcn_bytes) of a capture's collectives: the
    bytes of groups that cross slices are DCN, the rest (and every
    collective outside a declared group) ICI, the conservative reading."""

    ici = dcn = 0
    for c in comms:
        if c.dcn:
            dcn += c.wire
        else:
            ici += c.wire
    return ici, dcn
