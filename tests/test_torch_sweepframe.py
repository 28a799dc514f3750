"""The port's sweep-frame codec against the reference's.

``tpumon_torch.sweepframe`` is a copy of ``tpumon.sweepframe``'s
pure-Python encoder and decoder with imports renamed; the flight
recorder's segments are these frames.  On seeded sweeps (ints, floats,
non-finite floats, strings, vectors with blank and non-finite elements,
blanks, chips appearing and vanishing, piggybacked events, mid-stream
keyframes, partial and index-only frames) both encoders must emit the
same bytes, each decoder must read the other's frames into the same
mirror, and ``try_split_frame``/``split_frame`` must agree on every
truncation.  Tolerance: exact (bytes, and ``==`` with types).
"""

import numpy as np
import pytest

from tpumon import events as JEV
from tpumon import sweepframe as JS
from tpumon_torch import events as TEV
from tpumon_torch import sweepframe as TS

SEEDS = range(6)
FIDS = (150, 155, 203, 204, 52, 420, 2621)


def _value(rng):
    kind = rng.integers(0, 9)
    if kind == 0:
        return None
    if kind == 1:
        return int(rng.integers(-2**40, 2**40))
    if kind == 2:
        return float(rng.normal() * 1e3)
    if kind == 3:
        return float(rng.choice([np.nan, np.inf, -np.inf]))
    if kind == 4:
        return f"GPU-{int(rng.integers(0, 4))}-é"
    if kind == 5:
        return [None if rng.random() < 0.2 else
                (float(rng.normal()) if rng.random() < 0.5
                 else int(rng.integers(0, 100)))
                for _ in range(int(rng.integers(0, 5)))]
    if kind == 6:
        return float(int(rng.integers(0, 100)))  # integral float
    if kind == 7:
        return int(rng.integers(0, 3))
    return [float("nan"), 1, 2.0]


def _sweeps(seed, n=12):
    rng = np.random.default_rng(seed)
    chips = {c: {f: _value(rng) for f in FIDS} for c in range(3)}
    out = []
    for _ in range(n):
        snap = {}
        for c, vals in chips.items():
            if rng.random() < 0.15:
                continue  # chip lost this sweep
            for f in FIDS:
                if rng.random() < 0.3:
                    vals[f] = _value(rng)
            snap[c] = {f: (list(v) if isinstance(v, list) else v)
                       for f, v in vals.items()}
        out.append(snap)
    return out


def _events(mod, seed, k):
    rng = np.random.default_rng(1000 + seed + k)
    return [mod.Event(etype=mod.EventType(int(rng.integers(1, 15))),
                      timestamp=1700000000.0 + k + float(rng.random()),
                      seq=k * 3 + j, chip_index=int(rng.integers(-1, 3)),
                      uuid=f"GPU-{j}", message=f"Xid {k}µ {j}")
            for j in range(int(rng.integers(0, 3)))]


@pytest.mark.parametrize("seed", SEEDS)
def test_frames_equal_the_reference(seed):
    ref, port = JS.PySweepFrameEncoder(), TS.SweepFrameEncoder()
    assert TS.SweepFrameEncoder is TS.PySweepFrameEncoder
    for k, snap in enumerate(_sweeps(seed)):
        if k % 4 == 3:
            a, b = ref.encode_index_only_frame(), \
                port.encode_index_only_frame()
        else:
            a = ref.encode_frame(snap, _events(JEV, seed, k))
            b = port.encode_frame(snap, _events(TEV, seed, k))
        assert a == b
        assert ref.table_entries() == port.table_entries()


@pytest.mark.parametrize("seed", SEEDS)
def test_partial_and_keyframe_frames_equal_the_reference(seed):
    sweeps = _sweeps(seed, 6)
    start = 7 + seed
    ref, port = JS.PySweepFrameEncoder(start), TS.SweepFrameEncoder(start)
    for snap in sweeps:
        part = {c: v for c, v in snap.items() if c != 1}
        assert ref.encode_frame(part, partial=True) == \
            port.encode_frame(part, partial=True)


@pytest.mark.parametrize("seed", SEEDS)
def test_each_decoder_reads_the_others_frames(seed):
    enc = {"ref": JS.PySweepFrameEncoder(), "port": TS.SweepFrameEncoder()}
    dec = {("ref", "port"): JS.PySweepFrameDecoder(),
           ("port", "ref"): TS.SweepFrameDecoder(),
           ("port", "port"): TS.SweepFrameDecoder()}
    evmod = {"ref": JEV, "port": TEV}
    for k, snap in enumerate(_sweeps(seed)):
        frames = {side: enc[side].encode_frame(snap,
                                               _events(evmod[side], seed, k))
                  for side in enc}
        mirrors = {}
        for (src, dst), d in dec.items():
            payload, used = (TS if dst == "port" else JS).split_frame(
                frames[src])
            assert used == len(frames[src])
            events = d.apply(payload)
            mirrors[(src, dst)] = (d.mirror_snapshot(), d.last_changes,
                                   [(int(e.etype), e.seq, e.chip_index,
                                     e.timestamp, e.uuid, e.message)
                                    for e in events])
        snaps = list(mirrors.values())
        assert all(m == snaps[0] for m in snaps[1:])
        # the mirror holds the sweep, non-finite scalars as blanks
        want = {c: {f: (None if isinstance(v, float) and not np.isfinite(v)
                        else v) for f, v in vals.items()}
                for c, vals in snap.items()}
        got = snaps[0][0]
        assert set(got) == set(want)
        for c in want:
            for f, v in want[c].items():
                if isinstance(v, list):
                    assert len(got[c][f]) == len(v)
                else:
                    assert got[c][f] == v and type(got[c][f]) is type(v)


def test_materialize_and_adopted_index_equal_the_reference():
    snap = _sweeps(3, 1)[0]
    frame = JS.PySweepFrameEncoder(41).encode_frame(snap)
    payload, _ = JS.split_frame(frame)
    a, b = JS.PySweepFrameDecoder(True), TS.SweepFrameDecoder(True)
    a.apply(payload)
    b.apply(payload)
    req = [(0, [150, 155, 999]), (2, list(FIDS)), (7, [150])]
    assert a.materialize(req) == b.materialize(req)
    assert a._next_frame_index == b._next_frame_index == 42
    with pytest.raises(ValueError):
        TS.SweepFrameDecoder().apply(payload)  # index 41 != 0


@pytest.mark.parametrize("seed", SEEDS)
def test_split_agrees_on_every_truncation(seed):
    snap = _sweeps(seed, 1)[0]
    frame = JS.PySweepFrameEncoder().encode_frame(snap)
    for cut in range(len(frame) + 1):
        part = frame[:cut]
        assert TS.try_split_frame(part) == JS.try_split_frame(part)
        outcome = []
        for mod in (JS, TS):
            try:
                outcome.append(mod.split_frame(part))
            except ValueError as e:
                outcome.append(str(e))
        assert outcome[0] == outcome[1]
    bad = bytes([TS.SWEEP_FRAME_MAGIC]) + b"\xff" * 10
    for mod in (JS, TS):
        with pytest.raises(ValueError):
            mod.try_split_frame(bad)


def test_constants_equal_the_reference():
    assert (TS.SWEEP_FRAME_MAGIC, TS.SWEEP_REQ_MAGIC, TS.NUM_INT_LIMIT) == \
        (JS.SWEEP_FRAME_MAGIC, JS.SWEEP_REQ_MAGIC, JS.NUM_INT_LIMIT)
