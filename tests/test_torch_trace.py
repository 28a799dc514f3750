"""The port's profiler-trace engine (``tpumon_torch.trace``) held against
``tpumon.xplane`` on the same inputs, on the CPU.

* ``union_ps`` and ``leaf_attribution`` on seeded intervals: equal.
* The analyzer: one seeded timeline goes into both packages, as XSpace
  bytes (an ops line with ``hlo_category`` and ``flops`` stats, the
  encoder of ``tests/test_xplane.py``) and as the port's records, whose
  launching ops and kernel names map to the same categories.  Duty, busy
  time, every fraction, the TFLOP/s, ``n_ops`` and ``exact_categories``
  agree within 1e-9 absolute: the records carry integer nanoseconds and
  the reference integer picoseconds, 1000 times as many, so both run the
  same arithmetic.  Through a Chrome trace file the times pass through
  microseconds with three decimals: 1e-6 there.
* The engine's controls, the cases of ``tests/test_xplane.py:484-908``,
  scripted the same way on both engines through their profiler seams
  (``jax.profiler.start_trace``/``stop_trace``; the port's
  ``_start_profiler``/``_stop_profiler``), with the same outcome asserted.
* The port's own rules: the session belongs to the thread that opened it
  (a live CPU-activity capture on the thread running ``a @ b`` counts
  2*256**3 FLOPs per ``aten::mm``), the process-wide session lock, the
  CUDA activity never dropped, and the offline CLI on Chrome traces the
  tests write.
"""

import json
import os
import threading
import time
import types

import numpy as np
import pytest
import torch

from tpumon_torch import trace as T
from tpumon_torch.types import GPU_CAPS, gpu_caps

jax = pytest.importorskip("jax")

from tpumon import xplane as X  # noqa: E402
from test_xplane import (  # noqa: E402
    SID_CAT, SID_FLOPS, ev_meta_entry, event, line, plane, stat, tpu_plane,
    xspace)

H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---- the capability table --------------------------------------------------

def test_gpu_caps_table():
    # NVLink totals from the data sheets: the SXM5 part, the NVL's
    # bridge, none on the PCIe card
    assert gpu_caps(H100) == (80 * 1024, 3350.0, 989.0, 900.0)
    assert gpu_caps("NVIDIA H100 PCIe").bf16_tflops == 756.0
    assert gpu_caps("NVIDIA H100 PCIe").hbm_gbps == 2000.0
    assert gpu_caps("NVIDIA H100 PCIe").nvlink_gbps is None
    assert gpu_caps("NVIDIA H100 NVL") == (94 * 1024, 3900.0, 835.0, 600.0)
    assert gpu_caps("NVIDIA A100-SXM4-80GB") is None
    assert len(GPU_CAPS) == 3


# ---- interval arithmetic -----------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_union_and_leaf_attribution_equal_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 200))
    starts = rng.integers(0, 10_000, n)
    ends = starts + rng.integers(0, 500, n)
    cats = rng.choice(["mxu", "vector", "data", "a", "b"], n)
    ivals = [(int(s), int(e)) for s, e in zip(starts, ends)]
    tagged = [(s, e, str(c)) for (s, e), c in zip(ivals, cats)]
    assert T.union_ps(ivals) == X.union_ps(ivals)
    assert T.leaf_attribution(tagged) == X.leaf_attribution(tagged)
    assert T.union_ps([]) == X.union_ps([]) == 0


# ---- the analyzer against analyze_device_plane -------------------------------

#: category -> (the reference's hlo_category, the port's launching op)
EXACT = {"mxu": ("convolution fusion", "aten::mm"),
         "vector": ("loop fusion", "aten::add"),
         "data": ("copy", "aten::copy_"),
         "collective": ("all-reduce", "c10d::allreduce_")}
#: category -> (a device record the port sorts by its own kind, exactly)
BY_KIND = {"infeed": ("infeed", "Memcpy HtoD (Pageable -> Device)"),
           "outfeed": ("outfeed", "Memcpy DtoH (Device -> Pageable)")}
#: category -> (a reference op name without hlo_category, a port kernel
#: name without a launching op): both name matches, not exact
BY_NAME = {"mxu": ("dot.7", "nvjet_tst_128x128_64x6_2x1_v_bz_NNT"),
           "vector": ("fusion.3", "void at::native::elementwise_kernel<4>")}


def seeded_timeline(seed, n=120, exact_share=0.9):
    """[(start_ns, end_ns, category, exact, flops)]: overlapping streams,
    nested events, gaps."""

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        s = int(rng.integers(0, 700_000))
        e = s + int(rng.integers(1, 40_000))
        exact = rng.random() < exact_share
        pool = (list(EXACT) + list(BY_KIND)) if exact else list(BY_NAME)
        cat = str(rng.choice(pool))
        flops = int(rng.integers(1, 10**9)) if rng.random() < 0.5 else 0
        out.append((s, e, cat, exact, flops))
    return out


def reference_sample(timeline, window_s):
    metas, ops = [], []
    for i, (s, e, cat, exact, flops) in enumerate(timeline, start=1):
        stats = []
        if exact:
            hlo = (EXACT.get(cat) or BY_KIND[cat])[0]
            metas.append(ev_meta_entry(i, "m", f"op.{i}"))
            stats.append(stat(SID_CAT, s=hlo))
        else:
            metas.append(ev_meta_entry(i, "m", BY_NAME[cat][0]))
        if flops:
            stats.append(stat(SID_FLOPS, u64=flops))
        ops.append(event(i, s * 1000, (e - s) * 1000, *stats))
    data = xspace(tpu_plane(0, (), ops, metas))
    return X.analyze_xspace_bytes(data, window_s)[0]


def port_records(timeline):
    recs = []
    for s, e, cat, exact, flops in timeline:
        if exact and cat in EXACT:
            recs.append(T.TraceRecord("device", 0, s, e, "kernel",
                                      EXACT[cat][1]))
        elif exact:
            recs.append(T.TraceRecord("device", 0, s, e, BY_KIND[cat][1]))
        else:
            recs.append(T.TraceRecord("device", 0, s, e, BY_NAME[cat][1]))
        if flops:
            recs.append(T.TraceRecord(
                "op", 0, s, e, "aten::mm" if cat == "mxu" else "aten::mul",
                flops=flops))
    return recs


FIELDS = ("duty", "busy_s", "mxu_frac", "vector_frac", "data_frac",
          "infeed_stall", "outfeed_stall", "collective_stall",
          "achieved_tflops", "mxu_tflops")


def assert_samples_agree(ours, ref, tol):
    for f in FIELDS:
        assert getattr(ours, f) == pytest.approx(getattr(ref, f), abs=tol,
                                                 rel=0), f
    assert ours.n_ops == ref.n_ops
    assert ours.exact_categories == ref.exact_categories


@pytest.mark.parametrize("seed,exact_share,window_s", [
    (0, 1.0, 1e-3), (1, 0.97, 1e-3), (2, 0.9, 1e-3), (3, 0.5, 2e-3),
    (4, 0.0, 1e-3), (5, 1.0, 0.5e-3)])
def test_analyze_matches_reference(seed, exact_share, window_s):
    timeline = seeded_timeline(seed, exact_share=exact_share)
    ref = reference_sample(timeline, window_s)
    ours = T.analyze(port_records(timeline), window_s, {0: H100})[0]
    assert_samples_agree(ours, ref, 1e-9)
    # the peaks come from the capability table, not from the trace
    assert ours.peak_tflops == 989.0 and ours.peak_hbm_gbps == 3350.0
    assert ours.device_type == H100
    assert ours.achieved_hbm_gbps is None
    assert ours.ici_bytes_per_s is None and ours.gate_eligible_bytes is None


def test_analyze_without_flops_leaves_tflops_blank():
    timeline = [(s, e, c, x, 0) for s, e, c, x, _ in seeded_timeline(6)]
    ref = reference_sample(timeline, 1e-3)
    ours = T.analyze(port_records(timeline), 1e-3, {0: H100})[0]
    assert ref.achieved_tflops is None and ref.mxu_tflops is None
    assert ours.achieved_tflops is None and ours.mxu_tflops is None
    assert_samples_agree(ours, ref, 1e-9)


def test_unknown_card_has_no_peaks():
    s = T.analyze([T.TraceRecord("device", 0, 0, 10, "x")], 1e-6,
                  {0: "Some GPU"})[0]
    assert s.peak_tflops is None and s.peak_hbm_gbps is None
    assert s.device_type == "Some GPU"


def test_idle_capture_reads_zero_like_reference():
    """A capture that covered devices but recorded no device work: each
    reads duty 0 (the reference's '#ChipN' rule), host ops or not."""

    ref = X.analyze_xspace_bytes(
        xspace(plane("#Chip0 Host Interface", []), plane("#Chip1 Misc", []),
               plane("/host:CPU", [line("python", [])])), window_s=100e-6)
    host_op = T.TraceRecord("op", None, 0, 50, "aten::mm", flops=10)
    ours = T.analyze([host_op], 100e-6, {0: H100, 1: H100})
    assert set(ours) == set(ref) == {0, 1}
    for d in (0, 1):
        assert ours[d].duty == ref[d].duty == 0.0
        assert ours[d].n_ops == ref[d].n_ops == 0
        assert ours[d].exact_categories is ref[d].exact_categories is False


def test_mixed_capture_never_synthesizes_zeros_like_reference():
    busy = tpu_plane(1, [event(1, 0, 50_000_000)],
                     [event(1, 0, 50_000_000)],
                     [ev_meta_entry(1, "m", "jit")])
    ref = X.analyze_xspace_bytes(
        xspace(plane("#Chip0 Host Interface", []), busy), window_s=100e-6)
    ours = T.analyze([T.TraceRecord("device", 1, 0, 50_000, "k")], 100e-6,
                     {0: H100, 1: H100})
    assert set(ours) == set(ref) == {1}
    assert ours[1].duty == pytest.approx(ref[1].duty, abs=1e-9)


# ---- categorize --------------------------------------------------------------

@pytest.mark.parametrize("kernel,op,want", [
    # the port's own kernels, whatever launched them
    ("void (anonymous namespace)::flash_fwd_kernel<128>(bf16 const*)",
     "_Flash3", "mxu"),
    ("void (anonymous namespace)::flash_bwd_dq_kernel<64>(x)", None, "mxu"),
    ("void (anonymous namespace)::flash_bwd_dkv_kernel<128>(x)", None,
     "mxu"),
    ("(anonymous namespace)::mxu_kernel(__nv_bfloat16 const*)", None, "mxu"),
    ("(anonymous namespace)::stream_kernel(float const*, float*)", None,
     "vector"),
    # copies by direction, before their op
    ("Memcpy HtoD (Pageable -> Device)", "aten::copy_", "infeed"),
    ("Memcpy DtoH (Device -> Pinned)", "aten::_local_scalar_dense",
     "outfeed"),
    ("Memcpy DtoD (Device -> Device)", "aten::copy_", "data"),
    ("Memset (Device)", "aten::cudnn_convolution", "data"),
    # the launching aten op
    ("nvjet_tst_128x128_64x6_2x1_v_bz_TNT", "aten::mm", "mxu"),
    ("some_kernel", "aten::addmm", "mxu"),
    ("some_kernel", "aten::bmm", "mxu"),
    ("some_kernel", "aten::baddbmm", "mxu"),
    ("sm90_xmma_fprop_implicit_gemm_bf16", "aten::cudnn_convolution", "mxu"),
    ("some_kernel", "aten::convolution_backward", "mxu"),
    ("cudnn_generated_fort_native_sdpa_sm90_flash_fprop",
     "aten::_cudnn_attention_forward", "mxu"),
    ("some_kernel", "aten::_efficient_attention_forward", "mxu"),
    ("direct_copy_kernel", "aten::copy_", "data"),
    ("direct_copy_kernel", "aten::_to_copy", "data"),
    ("CatArrayBatchedCopy", "aten::cat", "data"),
    ("index_elementwise_kernel", "aten::index", "data"),
    ("scatter_gather_kernel", "aten::gather", "data"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "c10d::allreduce_",
     "collective"),
    ("some_kernel", "nccl:all_reduce", "collective"),
    ("vectorized_elementwise_kernel<4, GeluCUDA>", "aten::gelu", "vector"),
    ("convert_kernel", "aten::convert_element_type", "vector"),
    # the kernel's own name, with no op
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT", None, "mxu"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32", None, "mxu"),
    ("cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm>", None, "mxu"),
    ("void wgmma_kernel", None, "mxu"),
    ("cudnn::conv2d_grouped_direct_kernel", None, "mxu"),
    ("ncclKernel_AllGather_RING_LL", None, "collective"),
    # anything else
    ("void at::native::vectorized_elementwise_kernel<4>", None, "vector"),
    ("cudnn::batchnorm_fwd", None, "vector"),
])
def test_categorize_routes(kernel, op, want):
    assert T.categorize(kernel, op) == want


def test_exact_routes():
    exact = lambda k, o=None: T._route(k, o)[1]  # noqa: E731
    assert exact("x::flash_fwd_kernel<64>()") and exact("stream_kernel")
    assert exact("Memcpy HtoD (Pageable -> Device)") and exact("Memset (D)")
    assert exact("anything", "aten::add")
    assert not exact("nvjet_tst_x") and not exact("elementwise_kernel")


# ---- the live loaders --------------------------------------------------------

class FakeEvent:
    """The part of ``torch.autograd._KinetoEvent`` the loader reads."""

    def __init__(self, name, start, dur, *, dev=False, index=0, corr=0,
                 linked=0, thread=1, flops=0):
        self._v = dict(name=name, start=start, dur=dur, dev=dev, index=index,
                       corr=corr, linked=linked, thread=thread, flops=flops)

    def name(self):
        return self._v["name"]

    def start_ns(self):
        return self._v["start"]

    def duration_ns(self):
        return self._v["dur"]

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._v["dev"] else DeviceType.CPU

    def device_index(self):
        return self._v["index"]

    def correlation_id(self):
        return self._v["corr"]

    def linked_correlation_id(self):
        return self._v["linked"]

    def start_thread_id(self):
        return self._v["thread"]

    def flops(self):
        return self._v["flops"]


def conv_events():
    """aten::conv2d carries the FLOPs; its innermost op launches."""

    return [
        FakeEvent("aten::conv2d", 0, 100, corr=1, flops=1000),
        FakeEvent("aten::convolution", 5, 90, corr=2),
        FakeEvent("aten::cudnn_convolution", 10, 80, corr=3),
        FakeEvent("cudaLaunchKernel", 20, 5, corr=900, linked=3),
        FakeEvent("sm90_xmma_fprop_implicit_gemm", 200, 50, dev=True,
                  index=1, corr=900, linked=3),
        FakeEvent("aten::mm", 120, 30, corr=4, flops=64, thread=2),
        FakeEvent("nvjet_tst_x", 300, 20, dev=True, index=1, corr=901,
                  linked=4),
        # the profiler's own event whose CUPTI id collides with an op's
        FakeEvent("Lazy Function Loading", 400, 5, corr=5),
        FakeEvent("void elementwise_kernel", 410, 10, dev=True, index=1,
                  corr=902, linked=5),
        # launched outside any op (a ctypes kernel)
        FakeEvent("(anonymous namespace)::stream_kernel", 500, 40, dev=True,
                  index=1, corr=903, linked=0),
        FakeEvent("aten::add", 600, 10, corr=6, flops=7),  # no kernel
    ]


def test_kineto_records_link_ops_and_devices():
    recs = T.kineto_records(conv_events())
    dev = {r.name: r for r in recs if r.kind == "device"}
    assert dev["sm90_xmma_fprop_implicit_gemm"].op == \
        "aten::cudnn_convolution"
    assert dev["nvjet_tst_x"].op == "aten::mm"
    assert dev["void elementwise_kernel"].op is None
    assert dev["(anonymous namespace)::stream_kernel"].op is None
    assert all(r.device == 1 for r in dev.values())
    ops = {r.name: r for r in recs if r.kind == "op"}
    assert set(ops) == {"aten::conv2d", "aten::mm", "aten::add"}
    assert ops["aten::conv2d"].device == 1      # through its inner op
    assert ops["aten::conv2d"].flops == 1000
    assert ops["aten::mm"].device == 1
    assert ops["aten::add"].device is None      # launched nothing
    s = T.analyze(recs, 1e-6, {1: H100})[1]
    assert s.achieved_tflops == pytest.approx(1064 / 1e-6 / 1e12)
    assert s.mxu_tflops == pytest.approx(1064 / 1e-6 / 1e12)
    assert s.n_ops == 4


def lost_events(n_launch, n_kernel, step_ns=100_000, sync=True):
    """A session of ``n_launch`` launches ``step_ns`` apart, the first
    ``n_kernel`` of which kept their kernel records, closed by the
    profiler's device synchronize."""

    ev = [FakeEvent("aten::empty", 0, 10, corr=999)]
    for i in range(n_launch):
        ev.append(FakeEvent("cudaLaunchKernel", step_ns * i, 2000,
                            corr=1000 + i))
        if i < n_kernel:
            ev.append(FakeEvent("stream_kernel", step_ns * i + 5000, 4000,
                                dev=True, corr=1000 + i))
    t_end = step_ns * n_launch
    ev.append(FakeEvent("Memcpy DtoH (Device -> Pinned)", t_end, 2000,
                        dev=True, corr=5000))
    if sync:
        ev.append(FakeEvent("cudaDeviceSynchronize", t_end, 5000,
                            corr=5001))
    return ev


def drop_kernels(ev, lost):
    """``ev`` without the kernel records of the launches in ``lost``
    (their indices)."""

    return [e for e in ev if not (e._v["dev"] and e._v["corr"] - 1000 in lost)]


def test_lost_kernel_records_fail_the_capture():
    """Every host launch the session recorded must have its kernel record;
    a capture that lost them (CUPTI has dropped a whole capture's kernels
    while keeping its copies) must fail, never under-read duty."""

    # 300 launches over 30 ms: those within 5 ms of either edge exempt
    assert len(T.kineto_records(lost_events(300, 300))) == 301
    # the last launches' kernels ran after the session closed: exempt
    assert len(T.kineto_records(lost_events(300, 290))) == 291
    with pytest.raises(T.LostRecords, match="lost 200 of 200"):
        T.kineto_records(lost_events(300, 0))
    # the first launches' kernels fell before the recording: exempt too
    ev = drop_kernels(lost_events(300, 300), range(5))
    assert len(T.kineto_records(ev)) == 296
    # lost in the middle: 2 of 200 is over one and 1%, 1 of 200 is not
    for gap, fails in ((range(140, 143), True), (range(140, 142), False)):
        ev = drop_kernels(lost_events(300, 300), gap)
        if fails:
            with pytest.raises(T.LostRecords, match="lost 3 of 200"):
                T.kineto_records(ev)
        else:
            assert len(T.kineto_records(ev)) == 299

    class Lossy(T.TraceEngine):
        def _start_profiler(self):
            return object()

        @staticmethod
        def _stop_profiler(prof):
            class Result:
                def events(self):
                    return lost_events(300, 0)
            return Result()

    eng = Lossy(capture_ms=1, min_interval_s=0.0)
    assert eng.sample(0, wait=True) is None
    st = eng.stats()
    assert st["captures_failed"] == 1.0 and st["captures_ok"] == 0.0
    assert "LostRecords" in eng.last_error


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lost_second_half_fails_the_capture(seed):
    """CUPTI losing the tail of a capture (every kernel record after some
    point) must fail it: the exemption reaches only ``EDGE_NS`` into the
    session, never back to the last kernel that was recorded."""

    rng = np.random.default_rng(seed)
    n = int(rng.integers(200, 2000))
    step = int(rng.integers(100_000, 500_000))
    for sync in (True, False):
        ev = lost_events(n, n // 2, step_ns=step, sync=sync)
        edge = T.EDGE_NS // step + 1
        with pytest.raises(T.LostRecords) as e:
            T.kineto_records(ev)
        lost = int(str(e.value).split()[3])
        assert n - n // 2 - edge - 2 <= lost <= n - n // 2 - edge + 1
    # the same timeline with every kernel record kept passes
    assert len(T.kineto_records(lost_events(n, n, step_ns=step))) == n + 1


def test_launches_during_the_closing_sync_are_exempt():
    """Another thread launches while the close synchronizes the device:
    those kernels may run after the recording stopped."""

    ev = lost_events(300, 300)
    sync = next(e for e in ev if e.name() == "cudaDeviceSynchronize")
    sync._v["start"] = 200 * 100_000  # the synchronize began at launch 200
    assert len(T.kineto_records(drop_kernels(ev, range(160, 300)))) == 161
    with pytest.raises(T.LostRecords):
        T.kineto_records(drop_kernels(ev, range(100, 300)))


def test_live_capture_counts_mm_flops_on_its_thread():
    """The thread rule: the engine opens its session on the thread that
    runs ``a @ b`` and closes it there; each ``aten::mm`` carries
    2*256**3 FLOPs.  (A host without CUDA records the host's activity
    alone, which the engine itself never does.)"""

    class Rec(T.TraceEngine):
        records = []

        def _start_profiler(self):
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU],
                with_flops=True)
            prof.start()
            return prof

        def _collect(self, result, window_s):
            self.records = T.kineto_records(result.events())
            return T.analyze(self.records, window_s, {})

    eng = Rec(capture_ms=30, min_interval_s=0.0)
    a, b = torch.randn(256, 256), torch.randn(256, 256)
    assert eng.sample(0) is None           # opens the session, returns
    assert eng._session is not None
    n = 0
    while eng._session is not None:
        a @ b
        n += 1
        eng.poll()                         # closes it once the window ends
    assert eng.quiesce(10.0)
    mm = [r for r in eng.records if r.name == "aten::mm"]
    assert len(mm) == n
    assert sum(r.flops for r in mm) == n * 2 * 256 ** 3
    assert eng.stats()["captures_ok"] == 1.0


def test_session_closes_only_on_its_thread():
    eng, kit_starts = scripted_port_engine()
    assert eng.sample(0) is None
    sess = eng._session
    time.sleep(0.02)
    other = threading.Thread(target=lambda: (eng.poll(force=True),
                                             eng.sample(0)))
    other.start()
    other.join(10)
    assert not other.is_alive()
    assert eng._session is sess            # another thread cannot close it
    eng.poll()
    assert eng._session is None
    assert eng.quiesce(5.0)
    assert eng.stats()["captures_ok"] == 1.0 and kit_starts == [1]


def scripted_port_engine(**kw):
    """A port engine whose profiler is a stub (one start counter)."""

    starts = []

    class Stub(T.TraceEngine):
        def _start_profiler(self):
            starts.append(1)
            return object()

        @staticmethod
        def _stop_profiler(prof):
            return _NoEvents()

    kw.setdefault("capture_ms", 1)
    kw.setdefault("min_interval_s", 0.0)
    return Stub(**kw), starts


class _NoEvents:
    def events(self):
        return []


def test_peek_closes_an_elapsed_session_and_opens_none():
    eng, starts = scripted_port_engine(capture_ms=20)
    assert eng.peek(0) is None and starts == [] and eng._session is None
    assert eng.sample(0) is None and starts == [1]
    sess = eng._session
    assert eng.peek(0) is None and eng._session is sess   # window running
    time.sleep(0.03)
    assert eng.peek(0) is None and eng._session is None   # closed, parsed
    assert eng.quiesce(5.0) and eng.stats()["captures_ok"] == 1.0
    assert starts == [1]


def test_capture_fails_when_the_lock_is_taken():
    """Another session of the process holds the profiler: the capture
    counts as failed (never nests) and backs off like 'profiler busy'."""

    eng, starts = scripted_port_engine()
    with T.profiler_session():
        for _ in range(eng.MAX_CONSECUTIVE_FAILURES):
            assert eng.sample(0, wait=True) is None
        assert eng.capture_now(timeout_s=1.0) is False
    st = eng.stats()
    assert st["captures_failed"] == eng.MAX_CONSECUTIVE_FAILURES + 1
    assert st["captures_ok"] == 0.0 and starts == []
    assert st["disabled"] == 1.0
    assert not T.PROFILER_LOCK.locked()


def test_engine_session_holds_the_lock():
    eng, _ = scripted_port_engine(capture_ms=10_000)
    assert eng.sample(0) is None
    assert T.PROFILER_LOCK.locked()
    with pytest.raises(RuntimeError, match="stayed open"):
        with T.profiler_session(timeout_s=0.05):
            pass
    assert eng.quiesce(5.0)
    assert not T.PROFILER_LOCK.locked()
    with T.profiler_session(timeout_s=0.05):
        assert T.PROFILER_LOCK.locked()


def test_workloads_own_session_wins(monkeypatch):
    """A profiler session the workload already holds on this thread: the
    capture fails instead of nesting (which would end the outer one)."""

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    eng = T.TraceEngine(capture_ms=1, min_interval_s=0.0)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        assert eng.sample(0, wait=True) is None
    assert eng.stats()["captures_failed"] == 1.0
    assert "profiler busy" in eng.last_error


def test_cuda_capture_never_drops_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    eng = T.TraceEngine(capture_ms=1, min_interval_s=0.0)
    assert eng.sample(0, wait=True) is None
    assert eng.stats()["captures_failed"] == 1.0
    assert "CUDA is not available" in eng.last_error
    assert not T.PROFILER_LOCK.locked()


def test_profiler_initialization_is_no_capture_cost():
    """The engine's first session opens slowly (the profiler's one-time
    initialization, seconds on the card): that must not count as capture
    cost, or the duty cap would stretch the cadence to minutes."""

    eng, starts = scripted_port_engine(min_interval_s=15.0)
    slow_start = eng._start_profiler

    def start():
        if not starts:
            time.sleep(0.3)
        return slow_start()

    eng._start_profiler = start
    eng.sample(0, wait=True)
    st = eng.stats()
    assert st["capture_wall_s"] >= 0.3           # the wall keeps it
    assert 0.0 <= st["capture_cost_ewma_s"] < 0.1
    assert st["effective_interval_s"] == 15.0


def test_forced_capture_waits_out_this_threads_capture():
    """A periodic capture this thread holds runs its window out (the
    workload stepping in it) before the forced one opens: its cost then
    seeds the controllers at its real size."""

    eng, starts = scripted_port_engine(capture_ms=80, min_interval_s=0.0)
    assert eng.sample(0) is None           # the periodic session
    n = [0]

    def step():
        n[0] += 1
        time.sleep(0.001)

    assert eng.capture_now(timeout_s=5.0, step=step) is True
    assert starts == [1, 1] and n[0] > 0
    periodic = eng.capture_spans()[0]
    assert periodic[1] - periodic[0] >= 0.08
    st = eng.stats()
    assert st["captures_ok"] == 2.0
    assert st["capture_cost_ewma_s"] >= 0.0   # seeded by the periodic one


def test_step_raising_inside_a_forced_capture_closes_it():
    eng, _ = scripted_port_engine(capture_ms=10_000)

    def boom():
        raise ValueError("step failed")

    with pytest.raises(ValueError):
        eng.capture_now(timeout_s=5.0, step=boom)
    assert eng._session is None and not T.PROFILER_LOCK.locked()
    assert eng.stats()["capturing"] == 0.0


# ---- engine controls, both engines scripted alike ----------------------------

class Kit:
    """One engine under a scripted profiler: ``starts`` counts sessions;
    ``on_start``/``on_stop`` run inside them; ``inject`` makes every
    capture yield one canned sample."""

    def __init__(self, which, monkeypatch):
        self.which = which
        self.mod = X if which == "ref" else T
        self.mp = monkeypatch
        self.starts = 0
        self.on_start = lambda: None
        self.on_stop = lambda: None

        def start(*a, **k):
            self.starts += 1
            self.on_start()

        def stop(*a, **k):
            self.on_stop()

        if which == "ref":
            monkeypatch.setattr(jax.profiler, "start_trace", start)
            monkeypatch.setattr(jax.profiler, "stop_trace", stop)
        else:
            monkeypatch.setattr(T.TraceEngine, "_start_profiler",
                                lambda eng: (start(), object())[1])
            monkeypatch.setattr(T.TraceEngine, "_stop_profiler",
                                staticmethod(
                                    lambda prof: (stop(), _NoEvents())[1]))

    def engine(self, **kw):
        return self.mod.TraceEngine(**kw)

    def sample_obj(self, **kw):
        base = dict(ts=time.monotonic(), window_s=0.1, duty=0.7, busy_s=0.07,
                    mxu_frac=0.5, vector_frac=0.1, data_frac=0.05,
                    infeed_stall=0.02, outfeed_stall=0.0,
                    collective_stall=0.03)
        base.update(kw)
        return self.mod.TraceSample(**base)

    def inject(self):
        self.mp.setattr(self.mod.TraceEngine, "_collect",
                        lambda eng, x, window_s: {0: self.sample_obj()})

    def finish(self, eng, timeout_s=10.0):
        """Let a background capture end: the reference's runs on its own
        thread; the port's closes at this thread's next poll."""

        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.which == "port":
                eng.poll()
            with eng._lock:
                if not eng._capturing:
                    return
            time.sleep(0.01)
        raise AssertionError("capture did not finish")


@pytest.fixture
def kits(monkeypatch):
    return [Kit("ref", monkeypatch), Kit("port", monkeypatch)]


def test_engine_caches_within_interval(kits):
    for kit in kits:
        kit.inject()
        eng = kit.engine(capture_ms=1, min_interval_s=60.0)
        assert eng.sample(0, wait=True) is not None
        for _ in range(5):
            s = eng.sample(0)
            assert s is not None and s.duty == pytest.approx(0.7)
        assert kit.starts == 1, kit.which


def test_engine_staleness_and_wait_path(kits):
    for kit in kits:
        kit.inject()
        eng = kit.engine(capture_ms=1, min_interval_s=60.0)
        eng.sample(0, wait=True)
        with eng._lock:
            old = eng._samples[0]
            eng._samples[0] = kit.mod.TraceSample(
                **{**old.__dict__, "ts": old.ts - eng.stale_after_s - 1})
            eng._last_attempt = time.monotonic()  # not due again yet
        assert eng.sample(0) is None, kit.which
        assert eng.sample(0, wait=True) is None, kit.which
        assert kit.starts == 1


def test_engine_capture_now_ignores_cadence(kits):
    for kit in kits:
        kit.inject()
        eng = kit.engine(capture_ms=1, min_interval_s=3600.0)
        assert eng.sample(0, wait=True) is not None
        assert eng.sample(0) is not None
        assert kit.starts == 1
        assert eng.capture_now(timeout_s=5.0) is True
        assert kit.starts == 2, kit.which


def test_engine_duty_cap(kits):
    for kit in kits:
        kit.inject()
        eng = kit.engine(capture_ms=1, min_interval_s=15.0)
        eng.duty_cap = 0.02
        assert eng.sample(0, wait=True) is not None
        with eng._lock:
            eng._cost_ewma_s = 3.0
        assert eng._effective_interval() == pytest.approx(150.0)
        assert eng.stale_after_s == pytest.approx(450.0)
        assert eng.sample(0) is not None
        assert kit.starts == 1
        st = eng.stats()
        assert st["effective_interval_s"] == pytest.approx(150.0)
        assert st["capture_cost_ewma_s"] == pytest.approx(3.0)
        with eng._lock:
            eng._cost_ewma_s = 0.05       # cheap: never below the cadence
        assert eng._effective_interval() == pytest.approx(15.0)


def test_engine_on_demand_interval_never_stretched(kits):
    for kit in kits:
        eng = kit.engine(capture_ms=1, min_interval_s=0.0)
        eng.duty_cap = 0.02
        with eng._lock:
            eng._cost_ewma_s = 3.0
        assert eng._effective_interval() == 0.0
        eng.sample(0, wait=True)
        eng.sample(0, wait=True)
        assert kit.starts == 2, kit.which


def test_engine_failed_captures_accrue_cost(kits):
    for kit in kits:
        def slow_boom():
            time.sleep(0.05)
            raise RuntimeError("profiler died mid-session")

        kit.on_start = slow_boom
        eng = kit.engine(capture_ms=1, min_interval_s=15.0)
        eng.duty_cap = 0.02
        eng.sample(0, wait=True)
        st = eng.stats()
        assert st["captures_failed"] == 1.0, kit.which
        assert st["capture_wall_s"] > 0.0
        assert st["capture_cost_ewma_s"] >= 0.04
        assert st["effective_interval_s"] >= 0.04 / 0.02


def test_engine_capture_spans_include_in_flight(kits):
    for kit in kits:
        eng = kit.engine(capture_ms=1, min_interval_s=60.0)
        assert eng.capture_spans() == []
        t0 = time.monotonic() - 2.0
        with eng._lock:
            eng._capture_spans.append((t0 - 10.0, t0 - 7.0))
            eng._capturing = True
            eng._open_since = t0
        spans = eng.capture_spans()
        assert len(spans) == 2
        s, e = spans[-1]
        assert s == t0 and e >= t0 + 2.0
        with eng._lock:
            eng._capturing = False
            eng._open_since = None
        assert len(eng.capture_spans()) == 1


def test_engine_expensive_capture_shrinks_window(kits):
    for kit in kits:
        kit.on_stop = lambda: time.sleep(0.08)
        eng = kit.engine(capture_ms=200.0, min_interval_s=0.0)
        eng.cost_target_s = 0.01
        eng.WINDOW_FLOOR_MS = 5.0
        for _ in range(6):
            eng.sample(0, wait=True)
        assert eng.stats()["capture_window_ms"] < 100.0, kit.which
        assert eng._window_ms >= 5.0


def test_engine_cheap_capture_keeps_window(kits):
    for kit in kits:
        eng = kit.engine(capture_ms=200.0, min_interval_s=0.0)
        eng.cost_target_s = 0.5
        eng.WINDOW_FLOOR_MS = 5.0
        with eng._lock:
            eng._window_ms = 5.0
        for _ in range(8):
            eng.sample(0, wait=True)
        assert eng.stats()["capture_window_ms"] > 100.0, kit.which


def test_engine_forced_capture_uses_ceiling_window(kits, monkeypatch):
    slept = []
    real_sleep = time.sleep

    def rec_sleep(s):
        slept.append(s)
        real_sleep(min(s, 0.01))

    for kit in kits:
        eng = kit.engine(capture_ms=200.0, min_interval_s=60.0)
        with eng._lock:
            eng._window_ms = 50.0
            eng._cost_ewma_s = 2.0
        slept.clear()
        monkeypatch.setattr(time, "sleep", rec_sleep)
        assert eng.capture_now(timeout_s=5.0) is True
        monkeypatch.setattr(time, "sleep", real_sleep)
        assert slept and slept[0] == pytest.approx(0.2, abs=1e-3), kit.which
        assert eng._cost_ewma_s == 2.0
        assert eng._window_ms == 50.0
        assert len(eng.capture_spans()) == 1


def test_engine_quiesce_waits_out_inflight_capture(kits):
    for kit in kits:
        kit.on_stop = lambda: time.sleep(0.15)
        eng = kit.engine(capture_ms=1, min_interval_s=0.0)
        assert eng.sample(0) is None       # a background capture
        assert eng._atexit_registered is True
        time.sleep(0.01)
        assert eng.quiesce(timeout_s=3.0) is True, kit.which
        assert eng.stats()["captures_ok"] == 1.0
        before = eng._last_attempt
        eng.sample(0)
        time.sleep(0.05)
        assert eng._last_attempt == before
        with eng._lock:
            eng._disabled_until = 0.0
        eng.sample(0)
        time.sleep(0.05)
        assert eng._last_attempt == before
        assert eng.capture_now(timeout_s=0.5) is False
        assert eng.stats()["captures_ok"] == 1.0
        assert kit.starts == 1


def test_engine_quiesce_times_out_on_hung_capture(kits):
    for kit in kits:
        eng = kit.engine(capture_ms=1, min_interval_s=0.0)
        with eng._lock:
            eng._capturing = True
        t0 = time.monotonic()
        assert eng.quiesce(timeout_s=0.2) is False
        assert time.monotonic() - t0 < 2.0


def test_engine_failure_backoff(kits):
    for kit in kits:
        def boom():
            raise RuntimeError("profiler busy")

        kit.on_start = boom
        eng = kit.engine(capture_ms=1, min_interval_s=0.0)
        for _ in range(eng.MAX_CONSECUTIVE_FAILURES):
            eng.sample(0, wait=True)
        assert eng._disabled_until > time.monotonic(), kit.which
        before = eng._last_attempt
        assert eng.sample(0) is None
        time.sleep(0.01)
        assert eng._last_attempt == before
        assert eng.stats()["captures_failed"] == eng.MAX_CONSECUTIVE_FAILURES


def test_engine_wait_respects_inflight_capture(kits):
    """A wait=True caller never starts a second capture while one holds
    the single-flight claim (here: parsing on its own thread)."""

    for kit in kits:
        release = threading.Event()
        kit.mp.setattr(kit.mod.TraceEngine, "_collect",
                       lambda eng, x, w: (release.wait(timeout=10), {})[1])
        eng = kit.engine(capture_ms=1, min_interval_s=0.0)
        assert eng.sample(0) is None       # the background capture
        time.sleep(0.02)
        assert eng.sample(0, wait=True) is None, kit.which
        assert kit.starts == 1
        release.set()
        kit.finish(eng)


def test_engine_stats(kits):
    keys = []
    for kit in kits:
        kit.inject()
        eng = kit.engine(capture_ms=1, min_interval_s=60.0)
        st = eng.stats()
        assert st["captures_ok"] == 0 and st["sample_age_s"] == -1.0
        eng.sample(0, wait=True)
        st = eng.stats()
        assert 0 <= st["sample_age_s"] < 5.0
        assert st["disabled"] == 0.0
        assert st["attribution_suspect"] == 0.0
        assert st["attribution_consistency"] == -1.0
        keys.append(sorted(st))
    assert keys[0] == keys[1]


def test_engine_stats_count_failed_captures(kits):
    for kit in kits:
        def boom():
            raise RuntimeError("no profiler")

        kit.on_start = boom
        eng = kit.engine(capture_ms=1, min_interval_s=0.0)
        eng.sample(0, wait=True)
        assert eng.stats()["captures_failed"] == 1, kit.which


# ---- Chrome traces and the CLI -----------------------------------------------

def chrome_trace(records, devices=None):
    """A Chrome trace as Kineto writes it, from records (µs floats)."""

    events = []
    ext = 0
    for r in records:
        if r.kind != "device":
            continue
        ext += 1
        cat = ("gpu_memcpy" if r.name.startswith("Memcpy") else
               "gpu_memset" if r.name.startswith("Memset") else "kernel")
        args = {"device": r.device, "stream": 7, "correlation": ext}
        if r.op is not None:
            args["External id"] = ext
            events.append({"ph": "X", "cat": "cpu_op", "name": r.op,
                           "ts": r.start_ns / 1000.0 - 5.0, "dur": 1.0,
                           "pid": 1, "tid": 1,
                           "args": {"External id": ext}})
        events.append({"ph": "X", "cat": cat, "name": r.name,
                       "ts": round(r.start_ns / 1000.0, 3),
                       "dur": round((r.end_ns - r.start_ns) / 1000.0, 3),
                       "pid": 0, "tid": 7, "args": args})
    events.append({"ph": "i", "cat": "cpu_instant_event", "name": "x",
                   "ts": 0.0, "pid": 1, "tid": 1})
    return {"deviceProperties": [{"id": d, "name": n} for d, n in
                                 (devices or {0: H100}).items()],
            "traceEvents": events}


@pytest.mark.parametrize("seed", [0, 2, 3])
def test_chrome_trace_file_matches_in_process(tmp_path, seed):
    timeline = seeded_timeline(seed, exact_share=0.8)
    recs = port_records(timeline)
    path = tmp_path / "t.json"
    path.write_text(json.dumps(chrome_trace(recs)))
    ours = T.analyze_kineto_file(str(path), 1e-3)[0]
    ref = reference_sample(timeline, 1e-3)
    # the file carries no FLOPs
    assert ours.achieved_tflops is None and ours.mxu_tflops is None
    for f in FIELDS[:8]:
        assert getattr(ours, f) == pytest.approx(getattr(ref, f), abs=1e-6,
                                                 rel=0), f
    assert ours.n_ops == ref.n_ops
    assert ours.exact_categories == ref.exact_categories
    assert ours.peak_tflops == 989.0


def cli_trace(tmp_path, name="t.json", devices=None):
    us = 1000  # ns
    recs = [T.TraceRecord("device", 0, 0, 40 * us, "nvjet_tst_a", "aten::mm"),
            T.TraceRecord("device", 0, 40 * us, 60 * us,
                          "Memcpy DtoD (Device -> Device)", "aten::copy_"),
            T.TraceRecord("device", 0, 60 * us, 60 * us, "nvjet_tst_a",
                          "aten::mm")]
    f = tmp_path / name
    f.write_text(json.dumps(chrome_trace(recs, devices)))
    return str(f)


def test_cli_text_report(tmp_path, capsys):
    from tpumon_torch.cli.trace import main

    assert main([cli_trace(tmp_path), "--window", "100e-6"]) == 0
    out = capsys.readouterr().out
    assert f"device GPU:0 ({H100})" in out and "(given)" in out
    assert "duty 60.0%" in out
    assert "mxu 40.0%" in out and "data 20.0%" in out
    assert "(exact categories)" in out
    assert "peak 989.0 TFLOP/s  achieved n/a" in out
    assert "top kernels by self-time:" in out and "nvjet_tst_a" in out


def test_cli_json_and_inferred_window(tmp_path, capsys):
    from tpumon_torch.cli.trace import main

    assert main([cli_trace(tmp_path), "--json", "--top", "2"]) == 0
    r = json.loads(capsys.readouterr().out.strip())
    assert r["device"] == 0
    assert r["window_inferred"] is True
    # inferred window = the records' span (60 us): duty reads 1.0, an
    # upper bound
    assert r["window_s"] == pytest.approx(60e-6, rel=1e-6)
    assert r["duty"] == pytest.approx(1.0)
    assert [t["kernel"] for t in r["top_kernels"]] == [
        "nvjet_tst_a", "Memcpy DtoD (Device -> Device)"]
    assert r["top_kernels"][0]["n"] == 2
    assert r["achieved_tflops"] is None


def test_cli_no_device_records(tmp_path, capsys):
    from tpumon_torch.cli.trace import main

    f = tmp_path / "cpu.json"
    f.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 1.0,
         "dur": 2.0, "args": {"External id": 1}}]}))
    assert main([str(f)]) == 1
    assert "no device records" in capsys.readouterr().err


def test_cli_missing_and_malformed_files(tmp_path, capsys):
    from tpumon_torch.cli.trace import main

    assert main(["/nonexistent/trace.json"]) == 2
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert main([str(bad)]) == 2
    assert "bad.json" in capsys.readouterr().err


def test_cli_unknown_card_still_rendered(tmp_path, capsys):
    """A trace of a card the table does not know: duty and split are still
    reported, the peak reads n/a."""

    from tpumon_torch.cli.trace import main

    path = cli_trace(tmp_path, devices={0: "Some GPU"})
    assert main([path, "--window", "100e-6", "--top", "0"]) == 0
    out = capsys.readouterr().out
    assert "device GPU:0 (Some GPU)" in out
    assert "compute  peak n/a TFLOP/s  achieved n/a" in out
    assert "top kernels" not in out


# ---- the close: CUPTI torn down, and settled before the next session --------

class _Prof:
    """A stand-in session: records the teardown switch as Kineto reads it."""

    def __init__(self, activities):
        self.activities = set(activities)
        self.seen = "unread"
        self.profiler = types.SimpleNamespace(kineto_results="result")

    def stop(self):
        self.seen = os.environ.get(T.TEARDOWN_ENV)


@pytest.mark.parametrize("explicit,activities,seen,marked", [
    (None, ("CPU", "CUDA"), "1", True),     # the engine's own close
    (None, ("CUDA",), "1", True),
    ("0", ("CPU", "CUDA"), "0", False),     # torch's CUDA-graph workaround
    ("1", ("CPU", "CUDA"), "1", True),
    (None, ("CPU",), "1", False),           # no CUDA activity, no CUPTI
])
def test_engine_close_tears_cupti_down_unless_told(monkeypatch, explicit,
                                                   activities, seen, marked):
    from torch.profiler import ProfilerActivity

    monkeypatch.setattr(T, "_torn_at", None)
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: syncs.append(1))
    if explicit is None:
        monkeypatch.delenv(T.TEARDOWN_ENV, raising=False)
    else:
        monkeypatch.setenv(T.TEARDOWN_ENV, explicit)
    prof = _Prof(getattr(ProfilerActivity, a) for a in activities)
    assert T.TraceEngine._stop_profiler(prof) == "result"
    assert prof.seen == seen
    assert os.environ.get(T.TEARDOWN_ENV) == explicit  # restored
    assert (T._torn_at is not None) == marked
    # a torn-down close keeps calling into CUDA on its own thread for a
    # moment: the finalize lands there
    assert bool(syncs) == marked


def test_settle_waits_out_the_arm_time_then_synchronizes(monkeypatch):
    syncs = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda: syncs.append(time.monotonic()))
    monkeypatch.setattr(T, "TEARDOWN_ARM_S", 0.08)
    t0 = time.monotonic()
    monkeypatch.setattr(T, "_torn_at", t0)
    T.settle_teardown()
    assert syncs and syncs[-1] - t0 >= 0.08  # the last call after arming
    assert T._torn_at is None
    n = len(syncs)
    T.settle_teardown()                      # nothing torn down since
    assert len(syncs) == n
    # long after the close: one synchronize is the whole cost
    monkeypatch.setattr(T, "_torn_at", time.monotonic() - 10.0)
    T.settle_teardown()
    assert len(syncs) == n + 1


def test_settle_without_a_cuda_context_does_nothing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(T, "_torn_at", time.monotonic())
    T.settle_teardown()
    assert T._torn_at is None


def test_profiler_session_settles_before_and_marks_a_torn_close(
        monkeypatch):
    calls = []
    monkeypatch.setattr(T, "settle_teardown", lambda: calls.append("settle"))
    monkeypatch.setattr(T, "_torn_at", None)
    monkeypatch.setenv(T.TEARDOWN_ENV, "1")
    with T.profiler_session():
        calls.append("session")
    assert calls == ["settle", "session"] and T._torn_at is not None
    monkeypatch.setattr(T, "_torn_at", None)
    monkeypatch.delenv(T.TEARDOWN_ENV)
    with T.profiler_session():
        pass
    assert T._torn_at is None  # Kineto's default keeps CUPTI up
