"""The port's burst accumulator and sampler against the reference's.

``tpumon_torch.burst`` is a copy of ``tpumon.burst`` with imports renamed
(``BurstAccumulator`` is the facade: native when the port's codec
extension is loaded, ``PyBurstAccumulator`` otherwise; the native plane
is forced in ``tests/test_torch_codec_native.py``).  Seeded
sample streams — NaN/inf, blanks, strings and vectors, int/float type
flips, harvests interleaved with folds, anchor adoption across a swap —
must be harvested identically (``==`` with types) by both accumulators,
and their harvests must encode to the same sweep-frame bytes.
``BurstSampler`` windows under an injected clock (``harvest_if_due(now=)``)
as the reference's does; one test runs the real inner-loop thread for
under a second.  Tolerance: exact.
"""

import math
import threading
import time

import numpy as np
import pytest

from tpumon import burst as JB
from tpumon import sweepframe as JS
from tpumon_torch import _codec as TC
from tpumon_torch import burst as TB
from tpumon_torch import fields as TF
from tpumon_torch import sweepframe as TS

SEEDS = range(8)
SOURCES = (155, 203, 204, 206)


def _sample(rng):
    k = rng.integers(0, 10)
    if k == 0:
        return float(rng.choice([np.nan, np.inf, -np.inf]))
    if k == 1:
        return None
    if k == 2:
        return "busy" if rng.random() < 0.5 else [1, 2]
    if k in (3, 4):
        return int(rng.integers(0, 101))          # int samples
    if k == 5:
        return float(int(rng.integers(0, 101)))   # integral floats
    if k == 6:
        return float(rng.normal() * 1e16)         # past NUM_INT_LIMIT
    return float(rng.uniform(50.0, 700.0))


def _stream(seed, n=300):
    rng = np.random.default_rng(seed)
    t = 1000.0
    out = []
    for _ in range(n):
        t += float(rng.uniform(0.0, 0.02))
        chip = int(rng.integers(0, 2))
        out.append((chip, int(rng.choice(SOURCES)), t, _sample(rng),
                    rng.random() < 0.05))  # harvest after this sample
    return out


def _types(harvest):
    return {c: {f: (type(v), v if v == v else "nan") for f, v in vals.items()}
            for c, vals in harvest.items()}


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_and_harvest_equal_the_reference(seed):
    ref, port = JB.PyBurstAccumulator(), TB.BurstAccumulator()
    assert (port._nat is None) == (not TC.active())
    enc_r, enc_p = JS.PySweepFrameEncoder(), TS.SweepFrameEncoder()
    for chip, fid, t, v, cut in _stream(seed):
        for acc in (ref, port):
            if isinstance(v, (int, float)):
                acc.fold(chip, fid, t, v)
            else:
                acc.fold_series(chip, fid, [t], [v])
        if cut:
            a, b = ref.harvest(), port.harvest()
            assert _types(a) == _types(b)
            assert enc_r.encode_frame(a) == enc_p.encode_frame(b)
            assert ref.entries() == port.entries()
    assert _types(ref.harvest()) == _types(port.harvest())


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_series_equals_per_sample_folds(seed):
    """The batch fold is the per-sample fold, on both sides."""

    rng = np.random.default_rng(seed)
    ts = list(np.cumsum(rng.uniform(0.0, 0.02, 80)) + 5.0)
    vs = [_sample(rng) for _ in ts]
    out = []
    for mod in (JB, TB):
        one, batch = mod.PyBurstAccumulator(), mod.PyBurstAccumulator()
        for t, v in zip(ts, vs):
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                one.fold(0, 155, t, v)
        batch.fold_series(0, 155, ts, vs)
        h1, h2 = one.harvest(), batch.harvest()
        assert _types(h1) == _types(h2)
        out.append(_types(h2))
    assert out[0] == out[1]


@pytest.mark.parametrize("seed", SEEDS)
def test_anchor_adoption_equals_the_reference(seed):
    """The swap handoff: a fresh accumulator adopts the old one's
    anchors, so window integrals tile the total integral."""

    stream = [s for s in _stream(seed, 120) if isinstance(s[3], float)
              and math.isfinite(s[3]) and abs(s[3]) < 1e6]
    got = []
    for mod in (JB, TB):
        acc, harvests = mod.PyBurstAccumulator(), []
        for k, (chip, fid, t, v, cut) in enumerate(stream):
            acc.fold(chip, fid, t, v)
            if cut or k % 17 == 16:
                fresh = mod.PyBurstAccumulator()
                harvests.append(_types(acc.harvest()))
                fresh.adopt_anchors(acc)
                acc = fresh
        harvests.append(_types(acc.harvest()))
        got.append(harvests)
    assert got[0] == got[1]


def test_wire_number_equals_the_reference():
    for v in (0.0, -3.0, 2.5, 9e15, 8.999999e15, -1e16, float("nan"),
              float("inf"), float("-inf"), 1e-300, 123456789.0):
        a, b = JB.wire_number(v), TB.wire_number(v)
        assert type(a) is type(b)
        assert a == b or (a != a and b != b)


@pytest.mark.parametrize("side", ["ref", "port"])
def test_sampler_windows_under_an_injected_clock(side):
    """``harvest_if_due`` closes a window only when ``window_s`` has
    passed on the caller's clock, serves the previous harvest between,
    and carries the anchor into the next window."""

    mod = {"ref": JB, "port": TB}[side]
    s = mod.BurstSampler(lambda: {}, hz=50, window_s=1.0)
    acc = s._acc
    acc.fold(0, 155, 10.0, 100.0)
    acc.fold(0, 155, 10.5, 300.0)
    first = s.harvest_if_due(now=100.0)
    fid = TF.burst_id
    assert first == {0: {fid(155, 0): 100, fid(155, 1): 300,
                         fid(155, 2): 200, fid(155, 3): 50}}
    s._acc.fold(0, 155, 11.0, 200.0)
    # 0.5 s later on the caller's clock: the same window again
    assert s.harvest_if_due(now=100.5) is first
    second = s.harvest_if_due(now=101.0)
    # the adopted anchor (10.5, 300) gives the new window its area
    assert second == {0: {fid(155, 0): 200, fid(155, 1): 200,
                          fid(155, 2): 200, fid(155, 3): 150}}
    assert s.harvest_if_due(now=102.0) == {}
    assert s.stats() == {"burst_hz": 50.0, "burst_overruns": 0.0}


def test_sampler_thread_folds_and_counts_overruns():
    """The real inner loop, for under a second on each side: a source
    slower than the period shows as overruns, and the harvest holds what
    it folded."""

    for mod in (JB, TB):
        calls = []

        def slow():
            calls.append(time.monotonic())
            time.sleep(0.03)
            return {0: {155: 250.0, 203: 7, 206: None}}

        s = mod.BurstSampler(slow, hz=100)
        s.start()
        time.sleep(0.25)
        s.stop()
        h = s.harvest_if_due(now=1.0)
        assert s._thread is None and len(calls) >= 3
        assert s.stats()["burst_overruns"] >= 3
        assert h[0][TF.burst_id(155, 2)] == 250
        assert h[0][TF.burst_id(203, 1)] == 7
        assert TF.burst_id(206, 0) not in h[0]


def test_sampler_rejects_a_bad_rate_and_survives_a_raising_source():
    for mod in (JB, TB):
        with pytest.raises(ValueError):
            mod.BurstSampler(lambda: {}, hz=0)
        n = []

        def bad():
            n.append(1)
            raise RuntimeError("source down")

        s = mod.BurstSampler(bad, hz=200)
        s.start()
        time.sleep(0.05)
        s.stop()
        assert len(n) >= 2 and s.harvest_if_due(now=5.0) == {}
        assert not any(t.name == "tpumon-burst" and t.is_alive()
                       for t in threading.enumerate())
