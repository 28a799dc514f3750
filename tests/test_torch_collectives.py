"""The port's collective attribution (``tpumon_torch.collectives`` and
``trace.wire_fields``) against the JAX package's (``tpumon.collectives``
and the wire-byte half of ``tpumon.xplane.analyze_device_plane``).

* The per-kind ring bytes equal ``tpumon.collectives.wire_bytes`` on the
  same shapes and group sizes, exactly.
* gloo ranks (``tests/test_torch_ranks.py``, one pool of 4 for the
  module) step the ``allreduce``, ``dcn`` (2 slices x 2), ``pp``, ``moe``
  and ``ringattn`` loads once under a CPU profiler session: the bytes the
  port attributes equal the analytic ring bound of what gloo ran, exactly
  (a reduce-scatter ran as ``gloo:all_reduce`` over its input).
* The gates' cases of ``tests/test_collectives.py`` that carry over
  (synchronous collectives: the async start/done pairing has no torch
  counterpart): the port's fields on the same bytes and intervals equal
  the reference analyzer's at the reference's 200 GB/s ceiling.
* ``CudaBackend`` serves ``tpu_ici_*``/``tpu_dcn_*`` from a scripted
  ``TraceSample`` as ``PjrtBackend`` does from the same sample.
  ``--ici-per-link-modeled`` against the reference exporter is
  ``tests/test_torch_exporter.py::_modeled_pair``.
"""

import os
import sys

import pytest

from tpumon import collectives as RC
from tpumon_torch import collectives as C
from tpumon_torch import trace as T
from test_torch_ranks import RankPool

sys.path.insert(0, os.path.dirname(__file__))
from test_collectives import _attr_plane, _raw_plane  # noqa: E402

S = 1024 * 4  # one f32[1024]

#: (port kind, reference HLO op, reference instruction, port tensor sizes)
#: per kind, for a group of n
KINDS = {
    "allreduce": ("all-reduce",
                  lambda n, g: f"%ar = f32[1024]{{0}} all-reduce(f32[1024]"
                               f"{{0}} %p), {g}",
                  lambda n: [S]),
    "gather": ("all-gather",
               lambda n, g: f"%ag = f32[1024]{{0}} all-gather(f32["
                            f"{1024 // n}]{{0}} %p), {g}",
               lambda n: [S // n]),       # gloo records the shard only
    "scatter": ("reduce-scatter",
                lambda n, g: f"%rs = f32[{1024 // n}]{{0}} reduce-scatter("
                             f"f32[1024]{{0}} %p), {g}",
                lambda n: [S // n, S]),   # output and input
    "alltoall": ("all-to-all",
                 lambda n, g: f"%a = f32[1024]{{0}} all-to-all(f32[1024]"
                              f"{{0}} %p), {g}",
                 lambda n: [S]),
    "p2p": ("send",
            lambda n, g: "%s = f32[1024]{0} send(f32[1024]{0} %p), "
                         "channel_id=1",
            lambda n: [S]),
}


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_wire_bytes_per_kind_match_reference(kind, n):
    op, text, sizes = KINDS[kind]
    groups = "replica_groups={{" + ",".join(map(str, range(n))) + "}}"
    want = RC.wire_bytes(op, text(n, groups))
    payload = C.payload_bytes(kind, sizes(n), n)
    assert C.wire_bytes(kind, payload, n) == want
    # an unknown group size degrades to the factor 1.0 on both
    lb = RC.wire_bytes(op, text(n, "")) if kind != "gather" else S
    assert C.wire_bytes(kind, C.payload_bytes(kind, [S], None), None) == lb


@pytest.mark.parametrize("name,kind", [
    ("all_reduce", "allreduce"), ("allreduce_coalesced", "allreduce"),
    ("_reduce_scatter_base", "scatter"), ("reduce_scatter", "scatter"),
    ("all_gather", "gather"), ("_allgather_base", "gather"),
    ("all_to_all", "alltoall"), ("alltoall_base", "alltoall"),
    ("broadcast", "permute"), ("send", "p2p"), ("recv", "recv"),
    ("barrier", None), ("matmul", None)])
def test_collective_kind_of_backend_op_names(name, kind):
    assert C.collective_kind(name) == kind
    if kind in ("allreduce", "scatter", "gather", "alltoall"):
        ref = {"allreduce": "allreduce", "scatter": "scatter",
               "gather": "gather", "alltoall": "alltoall"}[kind]
        assert RC.collective_kind(name.strip("_").replace("_", "-")
                                  .replace("allgather", "all-gather")
                                  .replace("alltoall", "all-to-all")
                                  .replace("allreduce", "all-reduce")) == ref


def test_recv_counts_nothing_and_tensor_bytes():
    assert C.wire_bytes("recv", 4096, 2) == 0
    assert C.tensor_bytes([8, 16], "c10::BFloat16") == 256
    assert C.tensor_bytes([3], "float") == 12
    assert C.tensor_bytes([], "Scalar") == 0
    assert C.tensor_bytes([4], "no such type") == 0


# ---- gloo ranks under a profiler session ----------------------------------------

@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    pool = RankPool(4, str(tmp_path_factory.mktemp("ranks")))
    yield pool
    pool.close()


def _ring(kind, size, n):
    return C.wire_bytes(kind, size, n)


def _expected(pattern, rank, n=4):
    """(ici, dcn) bytes a rank moves in one step of ``pattern`` at the
    widths of ``test_torch_ranks.attributed_steps``: the ring bound of
    what gloo runs."""

    mib = 1024 * 1024
    if pattern == "allreduce":
        return _ring("allreduce", mib, n), 0
    if pattern == "dcn":           # 2 slices x 2 chips, 1 MiB a rank
        return (_ring("allreduce", mib, 2)          # RS: gloo all_reduce
                + _ring("gather", mib, 2), _ring("allreduce", mib // 2, 2))
    if pattern == "pp":            # d 32, batch 2, M = 2n: M+n-1 ticks
        hop = 2 * 32 * 2           # (batch, d) bf16, sent every tick
        wrap = 2 * n * 2 * 32 * 4  # (M, batch, d) f32, last stage only
        return (2 * n + n - 1) * hop + (wrap if rank == n - 1 else 0), 0
    if pattern == "moe":           # (n*c, d) bf16 twice, one f32 scalar
        tokens = n * (16 // n) * 32 * 2
        return 2 * _ring("alltoall", tokens, n) + _ring("allreduce", 4,
                                                        n), 0
    # ringattn: n rotations of K and V, (1, 2, 16, 8) bf16 each
    return n * 2 * (16 * 2 * 8 * 2), 0


@pytest.mark.parametrize("pattern", ["allreduce", "dcn", "pp", "moe",
                                     "ringattn"])
def test_attributed_bytes_equal_the_ring_bound_on_gloo(ranks4, pattern):
    outs = ranks4.run("attributed_steps", pattern, 2)
    for rank, (recs, seen) in enumerate(outs):
        recs = [C.CommRecord(*r) for r in recs]
        assert recs, seen
        assert all(r.n is not None for r in recs)  # every one in a scope
        assert C.split_bytes(recs) == _expected(pattern, rank)
        # every collective the backend recorded was attributed
        assert len(recs) == len(seen)
        fields = T.wire_fields(recs, [], 1.0, None, slices=True)
        assert fields["ici_bytes_per_s"] == _expected(pattern, rank)[0]
        assert fields["collective_events"] == len(seen)
        if pattern == "dcn":
            # what gloo ran: the reduce-scatter as an all-reduce of the
            # whole input, then the cross-slice all-reduce of the shard
            # and the all-gather of it
            assert [s[0] for s in seen] == ["gloo:all_reduce",
                                            "gloo:all_reduce",
                                            "gloo:all_gather"]
            assert [s[1][0] for s in seen] == [[262144], [131072],
                                               [131072]]
            assert [r.dcn for r in recs] == [False, True, False]


# ---- the gates, against the reference analyzer --------------------------------

def _rec(kind, payload, n, dur_ns, start_ns=0, dcn=False):
    return C.CommRecord(kind, payload, n, dcn, start_ns, start_ns + dur_ns,
                        C.wire_bytes(kind, payload, n))


def _port(recs, window_s, ceiling=200.0, slices=False):
    return T.wire_fields(recs, [(r.start_ns, r.end_ns) for r in recs],
                         window_s, ceiling, slices)


AR8 = "replica_groups={{0,1,2,3,4,5,6,7}}"


@pytest.mark.parametrize("elems,op_us", [
    (67108864, 50),   # physics: ~470 MB in a 100 us window
    (262144, 1),      # timeline: 9.2 us of wire time in 1 us
    (262144, 20),     # consistent
    (262144, 0),      # zero observed time with bytes
])
def test_gates_match_reference(elems, op_us):
    ref = _attr_plane(f"%ar = f32[{elems}]{{0}} all-reduce(%p), {AR8}",
                      op_dur_us=op_us)
    got = _port([_rec("allreduce", elems * 4, 8, op_us * 1000)], 100e-6)
    assert got["attribution_suspect"] is ref.attribution_suspect
    assert got["attribution_consistency"] == pytest.approx(
        ref.attribution_consistency, rel=1e-9)
    assert got["ici_bytes_per_s"] == pytest.approx(ref.ici_bytes_per_s)
    assert got["gate_eligible_bytes"] == ref.gate_eligible_bytes
    assert got["ici_ceiling_gbps"] == ref.ici_ceiling_gbps == 200.0


def test_dcn_bytes_do_not_trip_the_ici_physics_gate():
    ref = _attr_plane("%ar = f32[55000000]{0} all-reduce(%p), "
                      "replica_groups={{0,4},{1,5},{2,6},{3,7}}",
                      op_dur_us=900, window_us=1000,
                      slice_of=lambda i: i // 4)
    got = _port([_rec("allreduce", 55000000 * 4, 2, 900_000, dcn=True)],
                1000e-6, slices=True)
    assert got["ici_bytes_per_s"] == ref.ici_bytes_per_s == 0.0
    assert got["dcn_bytes_per_s"] == pytest.approx(ref.dcn_bytes_per_s)
    assert got["attribution_suspect"] is ref.attribution_suspect is False


def test_repeated_sync_ops_are_not_enveloped():
    """Two 1 us executions at the window's ends: their own intervals, not
    one envelope over the window, so the timeline gate fires."""

    from test_xplane import ev_meta_entry, event

    us = 1_000_000
    ar = f"%ar = f32[716800]{{0}} all-reduce(%p), {AR8}"
    ref = _raw_plane([ev_meta_entry(1, ar, "all-reduce.1"),
                      ev_meta_entry(3, "m", "jit_step")],
                     [event(3, 0, 100 * us)],
                     [event(1, 0, 1 * us), event(1, 99 * us, 1 * us)])
    recs = [_rec("allreduce", 716800 * 4, 8, 1000),
            _rec("allreduce", 716800 * 4, 8, 1000, start_ns=99_000)]
    got = _port(recs, 100e-6)
    assert got["attribution_consistency"] == pytest.approx(
        ref.attribution_consistency, rel=1e-9)
    assert got["attribution_suspect"] is ref.attribution_suspect is True


def test_dcn_split_and_latency_proxy():
    """Intra-slice reduce-scatter, cross-slice all-reduce twice (20 and
    10 us): the split and the mean cross-slice span equal the
    reference's with a slice map; without one everything is ICI and the
    DCN fields are blank."""

    from test_xplane import ev_meta_entry, event

    us = 1_000_000
    intra = ("%rs = f32[65536]{0} reduce-scatter(f32[262144]{0} %p), "
             "replica_groups={{0,1,2,3},{4,5,6,7}}, dimensions={0}")
    cross = ("%ar = f32[65536]{0} all-reduce(%rs), "
             "replica_groups={{0,4},{1,5},{2,6},{3,7}}")
    metas = [ev_meta_entry(1, intra, "reduce-scatter"),
             ev_meta_entry(2, cross, "all-reduce.1"),
             ev_meta_entry(3, "m", "jit_step")]
    ops = [event(1, 0, 20 * us), event(2, 20 * us, 20 * us),
           event(2, 45 * us, 10 * us)]
    recs = [_rec("scatter", 262144 * 4, 4, 20_000),
            _rec("allreduce", 65536 * 4, 2, 20_000, 20_000, dcn=True),
            _rec("allreduce", 65536 * 4, 2, 10_000, 45_000, dcn=True)]
    for slice_of, slices in ((lambda i: i // 4, True), (None, False)):
        ref = _raw_plane(metas, [event(3, 0, 60 * us)], ops,
                         slice_of=slice_of)
        got = _port(recs, 100e-6, slices=slices)
        for key in ("ici_bytes_per_s", "dcn_bytes_per_s",
                    "dcn_op_latency_us"):
            want = getattr(ref, key)
            assert got[key] == (pytest.approx(want) if want is not None
                                else None), key


def test_no_ceiling_runs_no_gate_and_no_collectives_read_zero():
    got = T.wire_fields([_rec("allreduce", 1 << 20, 8, 0)], [], 1e-4, None,
                        False)
    assert got["attribution_consistency"] is None
    assert got["attribution_suspect"] is False
    assert got["ici_ceiling_gbps"] is None
    idle = T.wire_fields([], [], 0.25, 900.0, False)
    assert idle["ici_bytes_per_s"] == 0.0 and idle["collective_events"] == 0
    assert idle["dcn_bytes_per_s"] is None


def test_analyze_attributes_the_comm_device_only():
    """Through ``trace.analyze``: the H100's NVLink ceiling (900 GB/s, the
    capability table), the collectives on this process's card, a measured
    0 on its other cards, and blank fields without an attribution."""

    rec = T.TraceRecord("device", 0, 0, 10_000, "ncclDevKernel_AllReduce",
                        "nccl:all_reduce")
    rec1 = T.TraceRecord("device", 1, 0, 10_000, "some_kernel", None)
    comms = [_rec("allreduce", 1 << 20, 2, 5_000)]
    names = {0: "NVIDIA H100 80GB HBM3", 1: "NVIDIA H100 80GB HBM3"}
    out = T.analyze([rec, rec1], 1e-3, names, comms, comm_device=0)
    assert out[0].ici_ceiling_gbps == 900.0
    assert out[0].ici_bytes_per_s == (1 << 20) / 1e-3
    assert out[0].collective_events == 1
    # the kernel's 10 us, not the host event's 5, bounds the wire time
    assert out[0].attribution_consistency == pytest.approx(
        ((1 << 20) / 900e9) / 10e-6)
    assert out[1].ici_bytes_per_s == 0.0
    assert T.analyze([rec], 1e-3, names)[0].ici_bytes_per_s is None
    assert T.analyze([rec], 1e-3, {0: "NVIDIA H100 PCIe"}, comms
                     )[0].ici_ceiling_gbps is None


# ---- the backend serving the families ----------------------------------------------

@pytest.mark.parametrize("wire", [
    dict(ici_bytes_per_s=0.0, ici_ceiling_gbps=900.0),
    dict(ici_bytes_per_s=1.5e9, ici_ceiling_gbps=900.0),
    dict(ici_bytes_per_s=2e12, ici_ceiling_gbps=900.0),
    dict(ici_bytes_per_s=3e8, dcn_bytes_per_s=2.5e8, dcn_op_latency_us=12.6),
    dict()])
def test_backend_serves_the_attribution_like_pjrt(wire):
    from test_torch_monitor import TRACE, _trace_pair
    from tpumon_torch import fields as TF

    F = TF.F
    fids = [int(f) for f in (F.ICI_TX_THROUGHPUT, F.ICI_RX_THROUGHPUT,
                             F.DCN_TX_THROUGHPUT, F.DCN_RX_THROUGHPUT,
                             F.DCN_TRANSFER_LATENCY)]
    ours, ref = _trace_pair(dict(TRACE, **wire), None, probes=False)
    got = ours.read_fields(0, fids)
    assert got == ref.read_fields(0, fids)
    tx = got[int(F.ICI_TX_THROUGHPUT)]
    assert tx == got[int(F.ICI_RX_THROUGHPUT)]
    if "ici_bytes_per_s" not in wire:
        assert tx is None
    elif wire["ici_bytes_per_s"] == 2e12:
        assert tx == 900_000  # clamped to the NVLink ceiling


class _Event:
    """A ``KinetoEvent``'s accessors, as the NCCL process group records a
    collective (torch 2.11 on an H100): the op, its ``record_param_comms``
    (group size last), the ``nccl:<op>`` host event with its tensor, and
    NCCL's kernel on the device under the op's name."""

    def __init__(self, name, start, dur, shapes=(), dtypes=(), args=(),
                 device=False):
        from torch.autograd import DeviceType

        self._v = (name, start, dur, [list(s) for s in shapes],
                   list(dtypes), list(args),
                   DeviceType.CUDA if device else DeviceType.CPU)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def shapes(self):
        return self._v[3]

    def dtypes(self):
        return self._v[4]

    def concrete_inputs(self):
        return self._v[5]

    def device_type(self):
        return self._v[6]


@pytest.mark.parametrize("param_n,want_n", [(4, 4), (None, 2)])
def test_nccl_records_group_size_and_device_events(param_n, want_n):
    """The group size NCCL's ``record_param_comms`` carries outranks the
    workload's scope; without it the scope's stands; the kernel NCCL runs
    under the op's name on the device is not a second collective."""

    events = [_Event("tpumon.group[n=2,dcn=0]", 0, 10_000),
              _Event("c10d::allreduce_", 100, 9_000)]
    if param_n is not None:
        events.append(_Event("record_param_comms", 200, 8_000,
                             args=[None, None, None, 0, None, [], [], 0, 1,
                                   param_n]))
    events += [_Event("nccl:all_reduce", 300, 1_000, [[1048576]], ["float"],
                      [None]),
               _Event("nccl:all_reduce", 2_000, 50_000, device=True)]
    recs = C.comm_records(events)
    assert len(recs) == 1
    r = recs[0]
    assert (r.kind, r.payload, r.n, r.dcn) == ("allreduce", 4 << 20, want_n,
                                              False)
    assert r.wire == RC.wire_bytes(
        "all-reduce", "%ar = f32[1048576]{0} all-reduce(%p), "
        "replica_groups={{" + ",".join(map(str, range(want_n))) + "}}")
