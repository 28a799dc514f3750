"""Active device probes: MEASURED utilization estimators for the embedded
(in-workload) monitor, on a CUDA device.

Counterpart of ``tpumon/backends/probes.py`` with the same probe sizes,
estimator math, ``abandon()`` and ``wait=False`` warmup; ``jax.jit``
becomes eager PyTorch and ``float()`` becomes ``.item()``.

* **queue-delay probe** — a tiny op's round-trip time.  The probes launch
  on the device's DEFAULT stream, the one the training step runs on, so
  a probe queues behind the workload's kernels and its latency rises
  while they run; against an idle-time calibration baseline this yields
  a duty-cycle estimator (DCGM ``gpu_utilization``, field 203).  A side
  stream would run beside the workload and read an idle chip under full
  load.
* **matmul headroom probe** — a chain of bf16 matmuls with known FLOPs;
  achieved TFLOP/s against the idle calibration gives ``1 - headroom``.
* **memory-stream headroom probe** — a known-byte-count elementwise pass;
  achieved GB/s against calibration estimates bandwidth contention.

These are *estimators*, not hardware counters: they conflate queueing
with occupancy and cost the device a bounded slice of time per probe
round (at most once per ``min_interval_s``).  Sizes: latency (8,128) add,
8 chained (1024,1024) bf16 matmuls (~17 GFLOP), one pass over 64 MiB of
f32 (~128 MiB moved).
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass
from typing import Optional

import torch


class ProbeAbandoned(Exception):
    """Raised between warmup phases once the owning backend closed: the
    remaining calibration is pure waste, and a daemon thread parked in
    the runtime at interpreter exit can take the process down."""


@dataclass
class ProbeSample:
    ts: float
    latency_us: float          # tiny-op round trip
    mm_tflops: float           # achieved by the matmul probe
    stream_gbps: float         # achieved by the stream probe
    duty_est: float            # 0..1 duty-cycle estimate
    mxu_active_est: float      # 0..1
    hbm_active_est: float      # 0..1


class ProbeEngine:
    """Per-device probe tensors + idle-time calibration + cached samples.

    Lazy: nothing touches the device until the first ``sample()``.
    ``sample()`` re-measures at most once per ``min_interval_s`` and
    serves the cached :class:`ProbeSample` otherwise, so a 10 ms exporter
    sweep cannot turn probes into load.
    """

    MM_N = 1024
    MM_CHAIN = 8
    STREAM_MIB = 64
    #: latency must exceed DEADBAND x baseline before an estimator reads
    #: above zero — dispatch jitter otherwise shows phantom utilization
    #: on an idle chip
    DEADBAND = 2.0

    def __init__(self, device, min_interval_s: float = 1.0) -> None:
        self._device = torch.device(device)
        self._min_interval = min_interval_s
        self._lock = threading.Lock()
        #: plain GIL-atomic bool, deliberately NOT under ``_lock``: the
        #: warmup thread holds the lock for the whole calibration, and
        #: abandon() must land mid-flight
        self._abandoned = False
        self._compiled = False
        self._warmup_thread: Optional[threading.Thread] = None
        self._last: Optional[ProbeSample] = None
        self._base_latency_us = 1.0
        self._base_mm_tflops = 1.0
        self._base_stream_gbps = 1.0

    # -- kernels --------------------------------------------------------------

    def _on_device(self):
        """Pin the calling thread to the probed device and its DEFAULT
        stream (thread-local in PyTorch: a warmup thread must set both)."""

        if self._device.type != "cuda":
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self._device))
        stack.enter_context(torch.cuda.stream(
            torch.cuda.default_stream(self._device)))
        return stack

    def _compile(self) -> None:
        # before ANY device traffic: an abandoned engine's backend is
        # closed, and the stream buffer alone is 64 MiB nobody will read
        self._check_abandoned()
        d = self._device
        # Every probe returns a SCALAR that the timer reads on the host
        # (.item()): CUDA launches are asynchronous, and a host readback
        # of a value cannot complete before the work that produced it;
        # the scalar is a REDUCTION over the result, so no probe work can
        # be skipped behind the readback.
        self._tiny = torch.zeros((8, 128), dtype=torch.float32, device=d)
        self._tiny_fn = lambda a: (a + 1.0)[0, 0]

        n = self.MM_N
        self._mm_x = torch.ones((n, n), dtype=torch.bfloat16, device=d) * 1e-3

        def chain(a):
            for _ in range(self.MM_CHAIN):
                a = a @ a
            return a.float().sum()
        self._mm_fn = chain
        self._mm_flops = 2.0 * (n ** 3) * self.MM_CHAIN

        rows = (self.STREAM_MIB * 1024 * 1024) // (2048 * 4)
        self._stream_x = torch.ones((rows, 2048), dtype=torch.float32,
                                    device=d)
        self._stream_fn = lambda a: (a * 1.0001 + 1.0).sum()
        self._stream_bytes = 2.0 * rows * 2048 * 4  # read + write

        # warm up then calibrate against an idle queue; each blocking
        # device round checks the abandonment flag
        self._check_abandoned()
        self._tiny_fn(self._tiny).item()
        self._check_abandoned()
        self._mm_fn(self._mm_x).item()
        self._check_abandoned()
        self._stream_fn(self._stream_x).item()
        self._check_abandoned()

        def median(xs):
            xs = sorted(xs)
            return xs[len(xs) // 2]

        def timed(fn, x, k):
            out = []
            for _ in range(k):
                self._check_abandoned()
                out.append(self._time(fn, x))
            return out

        # median, not min: the calibration runs once and a lucky fast
        # outlier would make every later comparison read as "busy"
        lat = median(timed(self._tiny_fn, self._tiny, 9))
        mmt = median(timed(self._mm_fn, self._mm_x, 5))
        stt = median(timed(self._stream_fn, self._stream_x, 5))
        self._base_latency_us = max(lat * 1e6, 1.0)
        self._base_mm_tflops = max(self._mm_flops / mmt / 1e12, 1e-6)
        self._base_stream_gbps = max(self._stream_bytes / stt / 1e9, 1e-6)
        self._compiled = True

    @staticmethod
    def _time(fn, x) -> float:
        t0 = time.perf_counter()
        fn(x).item()  # host readback: the only trustworthy completion signal
        return max(time.perf_counter() - t0, 1e-9)

    def _start_warmup(self) -> None:
        with self._lock:
            # an abandoned engine never calibrates, so without this gate
            # every later sweep would respawn a warmup thread only for it
            # to die at the first abandonment check
            if self._abandoned:
                return
            if self._compiled or (self._warmup_thread is not None and
                                  self._warmup_thread.is_alive()):
                return
            self._warmup_thread = threading.Thread(
                target=self.warmup, daemon=True, name="tpumon-probe-warmup")
            self._warmup_thread.start()

    # -- sampling -------------------------------------------------------------

    def baseline(self) -> Optional[dict]:
        """Idle-time calibration values (calibrating first if needed), or
        None on an abandoned engine — public paths never leak
        :class:`ProbeAbandoned`."""

        try:
            with self._lock, self._on_device():
                if not self._compiled:
                    self._compile()
                return {"latency_us": self._base_latency_us,
                        "mm_tflops": self._base_mm_tflops,
                        "stream_gbps": self._base_stream_gbps}
        except ProbeAbandoned:
            return None

    def _check_abandoned(self) -> None:
        if self._abandoned:
            raise ProbeAbandoned()

    def abandon(self) -> None:
        """Tell an in-flight warmup to stop at its next phase boundary."""

        self._abandoned = True

    def warmup(self) -> None:
        """Blocking calibration (call from a workload's own warmup phase).
        Returns quietly when the engine is abandoned mid-warmup."""

        try:
            with self._lock, self._on_device():
                if not self._compiled:
                    self._compile()
        except ProbeAbandoned:
            pass

    def sample(self, now: Optional[float] = None,
               wait: bool = True) -> Optional[ProbeSample]:
        """Measured sample, or the cached one within ``min_interval``.

        ``wait=False``: never block on the one-time calibration — start
        it on a background thread and return None (callers render the
        fields blank) until it finishes.

        An abandoned engine (backend closed) returns None on both paths.
        """

        now = time.monotonic() if now is None else now
        if self._abandoned:
            return None
        if not wait:
            with self._lock:
                ready = self._compiled
            if not ready:
                self._start_warmup()
                return None
        with self._lock, self._on_device():
            if (self._last is not None and
                    now - self._last.ts < self._min_interval):
                return self._last
            if not self._compiled:
                try:
                    self._compile()
                except ProbeAbandoned:  # abandon() raced the entry check
                    return None
            # re-check before ANY timed device op: a concurrent close()
            # may have abandoned us while we waited on the lock
            try:
                self._check_abandoned()
            except ProbeAbandoned:
                return None
            # median of 3: one jitter spike must not read as load, while
            # real queueing delays most of them
            lat_s = sorted(self._time(self._tiny_fn, self._tiny)
                           for _ in range(3))[1]
            mm_s = self._time(self._mm_fn, self._mm_x)
            st_s = self._time(self._stream_fn, self._stream_x)

            lat_us = lat_s * 1e6
            mm_tflops = self._mm_flops / mm_s / 1e12
            stream_gbps = self._stream_bytes / st_s / 1e9

            # duty: fraction of the probe's wall time spent waiting behind
            # other work.  idle -> lat ~= baseline -> 0 (the DEADBAND
            # absorbs jitter); saturated -> lat >> baseline -> ~1
            db = self.DEADBAND
            duty = max(0.0,
                       min(1.0, 1.0 - db * self._base_latency_us / lat_us))
            mxu = max(0.0, min(1.0, 1.0 - db * mm_tflops /
                               self._base_mm_tflops))
            hbm = max(0.0, min(1.0, 1.0 - db * stream_gbps /
                               self._base_stream_gbps))
            self._last = ProbeSample(ts=now, latency_us=lat_us,
                                     mm_tflops=mm_tflops,
                                     stream_gbps=stream_gbps,
                                     duty_est=duty, mxu_active_est=mxu,
                                     hbm_active_est=hbm)
            return self._last
