"""Binary delta sweep-frame codec: the flight recorder's file format.

The port's copy of ``tpumon/sweepframe.py``, with imports renamed.  A
sweep frame carries only the (chip, field) values whose ``(type, value)``
identity changed since the previous frame of the same stream, plus
blank/appear entries, removed-chip markers and piggybacked events; the
encoder keeps a delta table, the decoder a mirror, and the first frame of
a stream is a full snapshot.  The flight recorder (:mod:`tpumon_torch.
blackbox`) writes these frames as they are, and the burst accumulator
(:mod:`tpumon_torch.burst`) emits its values by the same number rule
(:data:`NUM_INT_LIMIT`).

:class:`SweepFrameEncoder` and :class:`SweepFrameDecoder` are thin
facades, as in the reference: when the port's native codec extension is
loaded (:mod:`tpumon_torch._codec`; ``native/codec/``) they dispatch to
native-owned delta-table/mirror handles that release the GIL around every
encode/decode, and the pure-Python classes (:class:`PySweepFrameEncoder`,
:class:`PySweepFrameDecoder`, the reference's executable spec) serve
otherwise.  ``tests/test_torch_sweepframe.py`` holds the Python classes
byte-identical to the JAX package's, ``tests/test_torch_codec_native.py``
the native ones.  The agent's binary request codec
(:func:`encode_sweep_request`/:func:`decode_sweep_request`) is here too:
the stream plane's server (:mod:`tpumon_torch.frameserver`) frames on its
magic.  Low-level emission comes from :mod:`tpumon_torch.wire`.

Number convention: finite integral doubles with ``|v| < 9e15`` travel as
Python ``int`` (zigzag varints), other finite doubles as fixed64 bits,
non-finite scalars as blanks.
"""

from __future__ import annotations

import struct
from typing import (Any, Dict, Iterable, List, Optional, Sequence, Tuple,
                    cast)

from . import _codec
from .backends.base import FieldValue
from .events import Event, EventType
from .wire import (iter_fields, read_varint, write_bytes_field,
                   write_double_field, write_varint, write_varint_field,
                   zigzag_encode)

#: lead byte of a binary sweep request (client -> agent); never the first
#: byte of a JSON request line (``{``)
SWEEP_REQ_MAGIC = 0xA6
#: lead byte of a binary sweep frame; likewise never the first byte of a
#: JSON response line
SWEEP_FRAME_MAGIC = 0xA9

#: the integral-dump rule of the reference's C++ agent: a finite double
#: equal to its floor with magnitude below this prints as an integer
NUM_INT_LIMIT = 9.0e15

_MISSING = object()

# -- request -------------------------------------------------------------------
#
# Payload fields:
#   1 (fixed64)  max_age_s double bits          (absent = any fresh value)
#   2 (varint)   events_since                   (absent = no event drain)
#   3 (bytes)*   explicit per-chip request: {1: chip, 2: packed fids}
#   4 (bytes)    shared packed fids
#   5 (bytes)    packed chip indices that use the shared fids
#
# Fields 4/5 exist because a whole-host sweep asks the SAME field list
# for every chip: encoding it once turns the per-sweep request from
# O(chips x fields) varints into O(chips + fields).


def encode_sweep_request(
        requests: Sequence[Tuple[int, Sequence[int]]],
        max_age_s: Optional[float],
        events_since: Optional[int]) -> bytes:
    """One varint-framed binary sweep request (magic + length + payload)."""

    body = bytearray()
    if max_age_s is not None:
        write_double_field(body, 1, float(max_age_s))
    if events_since is not None:
        write_varint_field(body, 2, int(events_since))
    groups: Dict[Tuple[int, ...], List[int]] = {}
    for idx, fids in requests:
        groups.setdefault(tuple(int(f) for f in fids), []).append(int(idx))
    shared: Tuple[int, ...] = ()
    if groups:
        shared = max(groups, key=lambda k: len(groups[k]))
    for fids_t, idxs in groups.items():
        if fids_t == shared:
            continue
        for idx in idxs:
            sub = bytearray()
            write_varint_field(sub, 1, idx)
            packed = bytearray()
            for f in fids_t:
                write_varint(packed, f)
            write_bytes_field(sub, 2, packed)
            write_bytes_field(body, 3, sub)
    if groups:
        packed = bytearray()
        for f in shared:
            write_varint(packed, f)
        write_bytes_field(body, 4, packed)
        packed = bytearray()
        for idx in groups[shared]:
            write_varint(packed, idx)
        write_bytes_field(body, 5, packed)
    head = bytearray((SWEEP_REQ_MAGIC,))
    write_varint(head, len(body))
    return bytes(head + body)


def _unpack_varints(data: bytes) -> List[int]:
    out: List[int] = []
    pos = 0
    while pos < len(data):
        v, pos = read_varint(data, pos)
        out.append(v)
    return out


def decode_sweep_request(payload: bytes) -> Tuple[
        List[Tuple[int, List[int]]], Optional[float], Optional[int]]:
    """Inverse of :func:`encode_sweep_request` (fake-agent/test half)."""

    max_age: Optional[float] = None
    events_since: Optional[int] = None
    reqs: List[Tuple[int, List[int]]] = []
    shared: List[int] = []
    shared_chips: List[int] = []
    for fno, wt, v in iter_fields(payload):
        if fno == 1 and wt == 1:
            assert isinstance(v, int)
            max_age = struct.unpack("<d", v.to_bytes(8, "little"))[0]
        elif fno == 2 and wt == 0:
            assert isinstance(v, int)
            events_since = v
        elif fno == 3 and wt == 2:
            assert isinstance(v, bytes)
            idx = -1
            fids: List[int] = []
            for f2, w2, v2 in iter_fields(v):
                if f2 == 1 and w2 == 0:
                    assert isinstance(v2, int)
                    idx = v2
                elif f2 == 2 and w2 == 2:
                    assert isinstance(v2, bytes)
                    fids = _unpack_varints(v2)
            reqs.append((idx, fids))
        elif fno == 4 and wt == 2:
            assert isinstance(v, bytes)
            shared = _unpack_varints(v)
        elif fno == 5 and wt == 2:
            assert isinstance(v, bytes)
            shared_chips = _unpack_varints(v)
    reqs.extend((c, list(shared)) for c in shared_chips)
    return reqs, max_age, events_since


# -- frame ---------------------------------------------------------------------
#
# Payload fields:
#   1 (varint)   frame index (0-based per connection; continuity check)
#   2 (bytes)*   chip delta: {1: chip, 2 (bytes)*: value entry}
#   3 (varint)*  removed chip (chip lost / dropped from the request:
#                purge every mirror entry for it)
#   4 (bytes)*   piggybacked event
#
# Value entry: {1: fid, then exactly one of
#   2 (varint)  zigzag int           5 (bytes)  UTF-8 string
#   3 (bytes)   vector submessage    6 (fixed64) double bits
#   4 (varint)  blank marker (JSON null)}
#
# Vector submessage: elements in wire order, each one of
#   {1: zigzag int, 2: double bits, 3: blank element}.


def _append_value(out: bytearray, fid: int, v: FieldValue) -> None:
    sub = bytearray()
    write_varint_field(sub, 1, fid)
    if v is None:
        write_varint_field(sub, 4, 1)
    elif isinstance(v, str):
        # delta-gated: a string value is re-encoded only on the sweep
        # where its identity changed, never steady-state
        write_bytes_field(sub, 5,
                          v.encode("utf-8"))  # tpumon-check: disable=hot-encode
    elif isinstance(v, list):
        vec = bytearray()
        for e in v:
            # type-preserving like the scalar case below: a Python
            # float element stays a float on the wire (json.dumps would
            # print "2.0"); only the C++ encoder — which has no
            # int/float distinction — applies the integral-dump rule
            if e is None:
                write_varint_field(vec, 3, 1)
            elif isinstance(e, float):
                if e != e or e in (float("inf"), float("-inf")):
                    write_varint_field(vec, 3, 1)
                else:
                    write_double_field(vec, 2, e)
            else:
                write_varint_field(vec, 1, zigzag_encode(int(e)))
        write_bytes_field(sub, 3, vec)
    elif isinstance(v, float):
        # type-preserving for the Python twin: a float stays a float on
        # the wire unless non-finite (the C++ server applies its
        # integral-dump rule before this point — it only has doubles)
        if v != v or v in (float("inf"), float("-inf")):
            write_varint_field(sub, 4, 1)
        else:
            write_double_field(sub, 6, v)
    else:  # int (bools travel as ints; the agent never produces them)
        write_varint_field(sub, 2, zigzag_encode(int(v)))
    write_bytes_field(out, 2, sub)


def _unchanged(prev: object, v: FieldValue) -> bool:
    """(type, value) identity match, the promtext convention: ``1`` /
    ``1.0`` / ``True`` are ``==`` but are different wire values.

    Lists are compared by contents AND element types — never by object
    identity, because a source may mutate a vector in place and hand
    over the same object (the table stores a copy for exactly this
    reason)."""

    if isinstance(v, list):
        # isinstance first (the narrowing mypy --strict needs), exact
        # __class__ second (list subclasses are different wire values)
        if not isinstance(prev, list) or prev.__class__ is not list:
            return False
        if prev != v:
            return False
        return all(a.__class__ is b.__class__ for a, b in zip(prev, v))
    if prev is v:
        return True
    return prev.__class__ is v.__class__ and prev == v


def _encode_events(events: Optional[Iterable[Event]]) -> bytes:
    """The piggybacked-event records (frame field 4).  Events are rare
    (one emission per drained event, never steady-state)."""

    body = bytearray()
    for e in events or ():
        ev = bytearray()
        write_varint_field(ev, 1, int(e.etype))
        write_varint_field(ev, 2, int(e.seq))
        write_varint_field(ev, 3, int(e.chip_index) + 1)
        write_double_field(ev, 4, float(e.timestamp))
        write_bytes_field(ev, 5,
                          e.uuid.encode("utf-8"))  # tpumon-check: disable=hot-encode
        write_bytes_field(ev, 6,
                          e.message.encode("utf-8"))  # tpumon-check: disable=hot-encode
        write_bytes_field(body, 4, ev)
    return bytes(body)


class PySweepFrameEncoder:
    """Per-stream delta table (the reference's pure-Python encoder).

    ``encode_frame`` takes the full computed sweep (chip -> fid ->
    value) and emits only what changed.

    ``start_index`` seeds the frame counter: the stream plane builds
    mid-stream keyframes with a throwaway encoder whose single full-snapshot frame must carry the
    SHARED stream's current index, so the subscriber's decoder resumes
    the live delta frames without a discontinuity.  The wire protocol
    itself always starts at 0 (a connection is a fresh stream).
    """

    def __init__(self, start_index: int = 0) -> None:
        #: chip -> fid -> last value sent on this connection
        self._last: Dict[int, Dict[int, FieldValue]] = {}
        self._frame_index = start_index

    def encode_frame(self, chips: Dict[int, Dict[int, FieldValue]],
                     events: Optional[Iterable[Event]] = None,
                     partial: bool = False) -> bytes:
        """One varint-framed frame (magic + length + payload).

        ``partial=True`` asserts that every table chip ABSENT from
        ``chips`` is unchanged since the last frame: the purge pass
        (removed-chip markers for absent chips) is skipped, so the
        caller can feed only the rows it KNOWS moved — the shard serve
        path does this with its per-row version scan, turning a
        4096-row steady tick into a dirty-subset encode.  Same
        caller-knows contract as :meth:`encode_index_only_frame`; the
        wire bytes for the chips that ARE passed are identical to a
        full-dict call."""

        body = bytearray()
        write_varint_field(body, 1, self._frame_index)
        self._frame_index += 1
        last = self._last
        # hot path (a full-churn frame at 256 chips x 56 fields is
        # ~15k changed entries — the flight-recorder tee pays this on
        # the sweep thread): the steady-state compare and the common
        # scalar emissions are inlined, with one reused scratch buffer
        # instead of a bytearray per entry.  Wire bytes are IDENTICAL
        # to the _append_value reference — pinned by the binary-vs-JSON
        # differential fuzz (tests/test_sweepframe_differential.py).
        scratch = bytearray()
        pack_d = struct.pack
        for idx, vals in chips.items():
            last_c = last.get(idx)
            sub: Optional[bytearray] = None
            if last_c is None:
                # a NEW chip emits its (possibly empty) block so the
                # client mirror learns the chip exists even before any
                # value lands
                last_c = last[idx] = {}
                sub = bytearray()
                write_varint_field(sub, 1, idx)
            lget = last_c.get
            for fid, v in vals.items():
                prev = lget(fid, _MISSING)
                if prev is not _MISSING:
                    # inlined _unchanged: identity, then same-type
                    # equality; lists take the slow path (contents AND
                    # element types, never object identity — the
                    # isinstance pair is the narrowing mypy --strict
                    # needs, and runs only for vector values)
                    if prev is v:
                        continue
                    if prev.__class__ is v.__class__:
                        if v.__class__ is not list:
                            if prev == v:
                                continue
                        elif (isinstance(prev, list)
                              and isinstance(v, list)
                              and prev == v and all(
                                  a.__class__ is b.__class__
                                  for a, b in zip(prev, v))):
                            continue
                if sub is None:
                    sub = bytearray()
                    write_varint_field(sub, 1, idx)
                del scratch[:]
                write_varint_field(scratch, 1, fid)
                if v is None:
                    scratch += b"\x20\x01"          # field 4, blank
                    last_c[fid] = v
                elif type(v) is float:
                    # type(v) is X == v.__class__ is X, spelled the way
                    # mypy --strict can narrow
                    if v != v or v in (float("inf"), float("-inf")):
                        scratch += b"\x20\x01"      # non-finite: blank
                    else:
                        scratch.append(0x31)        # field 6, fixed64
                        scratch += pack_d("<d", v)
                    last_c[fid] = v
                elif type(v) is int:
                    scratch.append(0x10)            # field 2, varint
                    write_varint(scratch,
                                 ((v << 1) ^ (v >> 63))
                                 & 0xFFFFFFFFFFFFFFFF)
                    last_c[fid] = v
                else:
                    # strings, vectors, bools, subclasses: reference
                    # emission (scratch holds the fid field already;
                    # rebuild through _append_value for exactness)
                    del scratch[:]
                    _append_value(sub, fid, v)
                    # copy lists into the table: the source may mutate
                    # its vector in place, and a table holding the same
                    # object would see every future compare as
                    # "unchanged"
                    last_c[fid] = list(v) if isinstance(v, list) else v
                    continue
                write_bytes_field(sub, 2, scratch)
            if sub is not None:
                write_bytes_field(body, 2, sub)
        # a chip that produced no value set this frame (lost, or dropped
        # from the request) is purged on BOTH sides so a reappearance is
        # a clean full re-send — unless the caller declared the frame
        # partial (absent chips are asserted unchanged, not gone)
        if not partial:
            for idx in [c for c in last if c not in chips]:
                del last[idx]
                write_varint_field(body, 3, idx)
        if events is not None:
            body += _encode_events(events)
        head = bytearray((SWEEP_FRAME_MAGIC,))
        write_varint(head, len(body))
        return bytes(head + body)

    def encode_index_only_frame(self) -> bytes:
        """One frame asserting "nothing changed": only the frame index,
        no chip blocks, no removals.  Semantically identical to calling
        :meth:`encode_frame` with exactly the values already in the
        table — but without paying the full (chip, field) compare pass.
        Callers may only use it when they KNOW the sweep is unchanged
        (the flight recorder's steady-state tee: the fleet poller's
        decoder reported ``last_changes == 0`` for the same sweep)."""

        body = bytearray()
        write_varint_field(body, 1, self._frame_index)
        self._frame_index += 1
        head = bytearray((SWEEP_FRAME_MAGIC,))
        write_varint(head, len(body))
        return bytes(head + body)

    def table_entries(self) -> int:
        return sum(len(c) for c in self._last.values())


def _decode_event(data: bytes) -> Event:
    etype = 0
    seq = 0
    chip = -1
    ts = 0.0
    uuid = ""
    message = ""
    for fno, wt, v in iter_fields(data):
        if fno == 1 and wt == 0:
            assert isinstance(v, int)
            etype = v
        elif fno == 2 and wt == 0:
            assert isinstance(v, int)
            seq = v
        elif fno == 3 and wt == 0:
            assert isinstance(v, int)
            chip = v - 1
        elif fno == 4 and wt == 1:
            assert isinstance(v, int)
            ts = struct.unpack("<d", v.to_bytes(8, "little"))[0]
        elif fno == 5 and wt == 2:
            assert isinstance(v, bytes)
            uuid = v.decode("utf-8", "replace")
        elif fno == 6 and wt == 2:
            assert isinstance(v, bytes)
            message = v.decode("utf-8", "replace")
    try:
        et = EventType(etype)
    except ValueError:
        et = EventType.NONE
    return Event(etype=et, timestamp=ts, seq=seq, chip_index=chip,
                 uuid=uuid, data={}, message=message)


class PySweepFrameDecoder:
    """Client-side mirror of the server's per-connection delta table —
    the reference's pure-Python decoder.

    One instance per connection: ``apply`` folds a frame's deltas into
    the mirror (raising ``ValueError`` on a frame-index discontinuity —
    the caller must tear the connection down, which resets BOTH
    tables), ``materialize`` builds the full ``{chip: {fid: value}}``
    snapshot the watch layer consumes.

    Ownership note: materialized chip dicts are freshly built per call,
    but unchanged vector values share list objects across sweeps (the
    decoder replaces, never mutates, stored lists) — same read-only
    contract ``WatchManager.update_all`` documents for its callers.

    ``adopt_first_index=True`` accepts whatever (non-negative) index
    the FIRST applied frame carries and enforces continuity from
    there: a subscriber attaching to a live stream mid-run starts at
    the stream's keyframe, whose index is the stream's running
    counter, not 0.  The wire-protocol client never passes it (a
    connection's first frame is always index 0).
    """

    def __init__(self, adopt_first_index: bool = False) -> None:
        self._mirror: Dict[int, Dict[int, FieldValue]] = {}
        self._next_frame_index = -1 if adopt_first_index else 0
        #: mutations the LAST applied frame made to the mirror (value
        #: entries + appeared + removed chips).  0 means the frame was
        #: index-only — the mirror, and therefore any materialized
        #: snapshot or aggregate derived from it, is bit-identical to
        #: the previous sweep's, so callers (the fleet multiplexer) can
        #: skip re-materializing/re-aggregating entirely.
        self.last_changes = 0

    def apply(self, payload: bytes) -> List[Event]:
        """Fold one frame payload (after magic + length) into the
        mirror; returns the piggybacked events (empty when none).

        Hot path (a full-churn frame at 256 chips x 20 fields is ~5k
        value entries per tick): chip blocks and value entries are
        parsed with inlined varint walking instead of nested
        :func:`iter_fields` generators — semantics identical (the
        reader's masking/truncation rules via :func:`read_varint`),
        pinned by the binary-vs-JSON differential fuzz
        (``tests/test_sweepframe_differential.py``)."""

        frame_index = -1
        changes = 0
        events: List[Event] = []
        mirror = self._mirror
        data = payload
        n = len(data)
        pos = 0
        unpack_d = struct.unpack
        while pos < n:
            b = data[pos]
            if b < 0x80:
                key = b
                pos += 1
            else:
                key, pos = read_varint(data, pos)
            fno, wt = key >> 3, key & 0x07
            if fno == 2 and wt == 2:  # chip delta block
                blen, pos = read_varint(data, pos)
                end = pos + blen
                if end > n:
                    raise ValueError("truncated sweep frame chip block")
                chip_m: Optional[Dict[int, FieldValue]] = None
                while pos < end:
                    b = data[pos]
                    if b < 0x80:
                        k2 = b
                        pos += 1
                    else:
                        k2, pos = read_varint(data, pos)
                    f2, w2 = k2 >> 3, k2 & 0x07
                    if f2 == 2 and w2 == 2:  # value entry
                        elen, pos = read_varint(data, pos)
                        e_end = pos + elen
                        if e_end > end:
                            raise ValueError(
                                "truncated sweep frame value entry")
                        if chip_m is None:
                            raise ValueError(
                                "sweep frame chip delta without an index")
                        fid = -1
                        val: FieldValue = None
                        while pos < e_end:
                            b = data[pos]
                            if b < 0x80:
                                k3 = b
                                pos += 1
                            else:
                                k3, pos = read_varint(data, pos)
                            f3, w3 = k3 >> 3, k3 & 0x07
                            if f3 == 1 and w3 == 0:
                                fid, pos = read_varint(data, pos)
                            elif f3 == 2 and w3 == 0:  # zigzag int
                                v3, pos = read_varint(data, pos)
                                val = (v3 >> 1) ^ -(v3 & 1)
                            elif f3 == 6 and w3 == 1:  # double bits
                                if pos + 8 > e_end:
                                    raise ValueError("truncated fixed64")
                                val = unpack_d(
                                    "<d", data[pos:pos + 8])[0]
                                pos += 8
                            elif f3 == 4 and w3 == 0:  # blank
                                _, pos = read_varint(data, pos)
                                val = None
                            elif f3 == 5 and w3 == 2:  # string
                                slen, pos = read_varint(data, pos)
                                if pos + slen > e_end:
                                    raise ValueError("truncated string")
                                val = data[pos:pos + slen].decode(
                                    "utf-8", "replace")
                                pos += slen
                            elif f3 == 3 and w3 == 2:  # vector
                                vlen, pos = read_varint(data, pos)
                                v_end = pos + vlen
                                if v_end > e_end:
                                    raise ValueError("truncated vector")
                                vec: List[object] = []
                                vappend = vec.append
                                while pos < v_end:
                                    k4, pos = read_varint(data, pos)
                                    f4, w4 = k4 >> 3, k4 & 0x07
                                    if f4 == 1 and w4 == 0:
                                        v4, pos = read_varint(data, pos)
                                        vappend((v4 >> 1) ^ -(v4 & 1))
                                    elif f4 == 2 and w4 == 1:
                                        if pos + 8 > v_end:
                                            raise ValueError(
                                                "truncated fixed64")
                                        vappend(unpack_d(
                                            "<d", data[pos:pos + 8])[0])
                                        pos += 8
                                    elif f4 == 3 and w4 == 0:
                                        _, pos = read_varint(data, pos)
                                        vappend(None)
                                    else:
                                        raise ValueError(
                                            "unknown vector element field")
                                val = vec  # type: ignore[assignment]
                            else:
                                raise ValueError(
                                    f"unknown value entry field {f3}")
                        if fid < 0:
                            raise ValueError(
                                "sweep frame value entry without a "
                                "field id")
                        chip_m[fid] = val
                        changes += 1
                    elif f2 == 1 and w2 == 0:  # chip index
                        idx, pos = read_varint(data, pos)
                        chip_m = mirror.get(idx)
                        if chip_m is None:
                            chip_m = mirror[idx] = {}
                            changes += 1  # chip appeared
                    else:
                        raise ValueError(
                            f"unknown chip delta field {f2}")
            elif fno == 1 and wt == 0:
                frame_index, pos = read_varint(data, pos)
            elif fno == 3 and wt == 0:
                gone, pos = read_varint(data, pos)
                if mirror.pop(gone, None) is not None:
                    changes += 1
            elif fno == 4 and wt == 2:
                elen, pos = read_varint(data, pos)
                if pos + elen > n:
                    raise ValueError("truncated sweep frame event")
                events.append(_decode_event(data[pos:pos + elen]))
                pos += elen
            else:
                raise ValueError(f"unknown sweep frame field {fno}/{wt}")
        if frame_index != self._next_frame_index and not (
                self._next_frame_index < 0 and frame_index >= 0):
            raise ValueError(
                f"sweep frame index {frame_index} != expected "
                f"{self._next_frame_index} (delta stream desynchronized)")
        # frame_index == _next_frame_index except on an adopted first
        # frame, where the stream's running index becomes the baseline
        self._next_frame_index = frame_index + 1
        self.last_changes = changes
        return events

    def materialize(self, requests: Sequence[Tuple[int, Sequence[int]]],
                    ) -> Dict[int, Dict[int, FieldValue]]:
        """Full snapshot for the watch layer, filtered to the request —
        exactly the chips/fields the JSON path would return (a chip the
        agent never delivered, e.g. lost before the first frame, is
        omitted; a field that left the request is not resurrected from
        the mirror)."""

        mirror = self._mirror
        out: Dict[int, Dict[int, FieldValue]] = {}
        for idx, fids in requests:
            chip_m = mirror.get(idx)
            if chip_m is None:
                continue
            if len(chip_m) == len(fids):
                # common case: the mirror holds exactly the requested
                # fields — one C-speed dict copy instead of a per-fid
                # comprehension
                out[idx] = dict(chip_m)
            else:
                cget = chip_m.get
                sentinel = _MISSING
                vals = {}
                for f in fids:
                    v = cget(f, sentinel)
                    if v is not sentinel:
                        vals[f] = v
                out[idx] = vals
        return out

    def mirror_snapshot(self) -> Dict[int, Dict[int, FieldValue]]:
        """The full mirror as ``{chip: {fid: value}}`` — every entry the
        stream has delivered, unfiltered by any request list.  The
        flight-recorder replay path uses this: a recorded stream has no
        separate notion of "the request", the frames ARE the contract.
        Chip dicts are fresh copies; vector values share list objects
        (same read-only contract as :meth:`materialize`)."""

        return {idx: dict(vals) for idx, vals in self._mirror.items()}

    def mirror_entries(self) -> int:
        return sum(len(c) for c in self._mirror.values())


# -- facades -------------------------------------------------------------------
#
# The production names.  One instance = one native handle (delta table /
# mirror owned by the extension, GIL released around the hot work) when
# the extension is importable, else one pure-Python reference object.
# Native handles are SINGLE-OWNER: concurrent entry from a second
# thread raises RuntimeError instead of corrupting the table (the native
# busy flag turns a violation into a loud error instead of a silent
# race).  `close()` frees the native table immediately — further use
# raises ValueError — and is optional (dropping the last reference
# frees it too).

if _codec.lib is not None:
    _n = _codec.lib
    if (int(_n.SWEEP_FRAME_MAGIC) != SWEEP_FRAME_MAGIC
            or int(_n.SWEEP_REQ_MAGIC) != SWEEP_REQ_MAGIC
            or float(_n.NUM_INT_LIMIT) != NUM_INT_LIMIT):
        # a stale build must degrade to the reference, never emit
        # drifted bytes
        _codec.reject(
            "native codec wire constants disagree with tpumon_torch/"
            "sweepframe.py (rebuild: python -m tpumon_torch._build --native)")
    del _n


class SweepFrameEncoder:
    """The shared server-side delta table (native-backed facade).

    Same contract as :class:`PySweepFrameEncoder` (which serves as the
    fallback and the executable spec): ``start_index`` seeds the frame
    counter for mid-stream keyframes, ``encode_frame(partial=True)``
    skips the purge pass for dirty-row serves, byte output is identical
    between backends.
    """

    __slots__ = ("_nat", "_py")

    def __init__(self, start_index: int = 0) -> None:
        lib = _codec.lib
        if lib is not None:
            self._nat: Optional[Any] = lib.Encoder(start_index=start_index)
            self._py: Optional[PySweepFrameEncoder] = None
        else:
            self._nat = None
            self._py = PySweepFrameEncoder(start_index)

    def encode_frame(self, chips: Dict[int, Dict[int, FieldValue]],
                     events: Optional[Iterable[Event]] = None,
                     partial: bool = False) -> bytes:
        nat = self._nat
        if nat is not None:
            blob = _encode_events(events) if events is not None else b""
            return cast(bytes, nat.encode_frame(chips, blob, partial))
        py = self._py
        assert py is not None
        # pure-Python fallback: the reference IS the product here
        return py.encode_frame(chips, events, partial)  # tpumon: codec-ok(facade fallback: the extension is absent, the reference IS the product here)

    def encode_index_only_frame(self) -> bytes:
        nat = self._nat
        if nat is not None:
            return cast(bytes, nat.encode_index_only_frame())
        py = self._py
        assert py is not None
        return py.encode_index_only_frame()

    def table_entries(self) -> int:
        nat = self._nat
        if nat is not None:
            return cast(int, nat.table_entries())
        py = self._py
        assert py is not None
        return py.table_entries()

    def close(self) -> None:
        """Free the native delta table now (no-op on the reference
        backend).  The handle is unusable afterwards."""

        nat = self._nat
        if nat is not None:
            nat.close()


class SweepFrameDecoder:
    """The shared client-side mirror (native-backed facade).

    Same contract as :class:`PySweepFrameDecoder`: ``apply`` folds one
    frame payload and returns the piggybacked events,
    ``adopt_first_index=True`` accepts a mid-stream keyframe's index,
    ``materialize``/``mirror_snapshot`` build request-filtered / full
    snapshots (fresh dicts; unchanged vector values share list objects
    — the documented read-only contract).  ``host_aggregate`` is the
    native fleet fast path: the per-host aggregate computed directly
    off the native mirror, skipping materialize entirely (None on the
    reference backend — callers fall back to
    ``fleetpoll.aggregate_host_sample``).
    """

    __slots__ = ("_nat", "_py", "last_changes")

    def __init__(self, adopt_first_index: bool = False) -> None:
        lib = _codec.lib
        if lib is not None:
            self._nat: Optional[Any] = lib.Decoder(
                adopt_first_index=adopt_first_index)
            self._py: Optional[PySweepFrameDecoder] = None
        else:
            self._nat = None
            self._py = PySweepFrameDecoder(adopt_first_index)
        self.last_changes = 0

    def apply(self, payload: bytes) -> List[Event]:
        nat = self._nat
        if nat is not None:
            raw = nat.apply(payload)
            self.last_changes = int(nat.last_changes())
            return [_decode_event(b) for b in raw]
        py = self._py
        assert py is not None
        events = py.apply(payload)  # tpumon: codec-ok(facade fallback: the extension is absent, the reference IS the product here)
        self.last_changes = py.last_changes
        return events

    def try_apply(self, data: "bytes | bytearray",
                  ) -> Optional[Tuple[int, List[Event]]]:
        """Fused :func:`try_split_frame` + :meth:`apply` over the head
        of a receive buffer: parse one framed message in place (no
        payload slice copy, ONE native call on the hot path) ->
        ``(total_consumed, events)``, or ``None`` when more bytes are
        needed.  The caller already matched the lead byte against the
        frame magic and deletes ``total_consumed`` bytes on success."""

        nat = self._nat
        if nat is not None:
            r = nat.try_apply(data)
            if r is None:
                return None
            used, changes, raw = r
            self.last_changes = changes
            return used, [_decode_event(b) for b in raw]
        parsed = try_split_frame(data)
        if parsed is None:
            return None
        payload, used = parsed
        py = self._py
        assert py is not None
        events = py.apply(payload)  # tpumon: codec-ok(facade fallback: the extension is absent, the reference IS the product here)
        self.last_changes = py.last_changes
        return used, events

    def materialize(self, requests: Sequence[Tuple[int, Sequence[int]]],
                    ) -> Dict[int, Dict[int, FieldValue]]:
        nat = self._nat
        if nat is not None:
            return cast("Dict[int, Dict[int, FieldValue]]",
                        nat.materialize(requests))
        py = self._py
        assert py is not None
        return py.materialize(requests)

    def mirror_snapshot(self) -> Dict[int, Dict[int, FieldValue]]:
        nat = self._nat
        if nat is not None:
            return cast("Dict[int, Dict[int, FieldValue]]",
                        nat.mirror_snapshot())
        py = self._py
        assert py is not None
        return py.mirror_snapshot()

    def mirror_entries(self) -> int:
        nat = self._nat
        if nat is not None:
            return cast(int, nat.mirror_entries())
        py = self._py
        assert py is not None
        return py.mirror_entries()

    def host_aggregate(
            self, requests: Sequence[Tuple[int, Sequence[int]]],
            chip_count: int, fids: Tuple[int, int, int, int, int, int, int],
    ) -> Optional[Tuple[int, int, float, Optional[int], Optional[float],
                        Optional[float], int, int, int]]:
        """Native mirror aggregate: ``(live_fields, dead_chips,
        power_w, max_temp, mean_tc, mean_hbm, hbm_used, hbm_total,
        links_up)`` — exactly what ``aggregate_host_sample`` computes
        from ``materialize(requests)``, without building a single
        Python dict.  ``fids`` is the seven aggregate field ids in
        (power, temp, tc_util, hbm_bw, hbm_used, hbm_total, links)
        order.  Returns None on the reference backend; raises
        OverflowError when a value needs the exact Python path."""

        nat = self._nat
        if nat is None:
            return None
        # string-form cast: a subscripted generic here would be
        # EVALUATED per call (typing generic-alias hashing showed up in
        # the fleet tick profile)
        return cast(
            "Tuple[int, int, float, Optional[int], Optional[float],"
            " Optional[float], int, int, int]",
            nat.aggregate(requests, chip_count, fids))

    @property
    def _next_frame_index(self) -> int:
        nat = self._nat
        if nat is not None:
            return cast(int, nat.next_frame_index())
        py = self._py
        assert py is not None
        return py._next_frame_index

    def close(self) -> None:
        """Free the native mirror now (no-op on the reference backend).
        The handle is unusable afterwards."""

        nat = self._nat
        if nat is not None:
            nat.close()


def try_split_frame(data: "bytes | bytearray",
                    ) -> Optional[Tuple[bytes, int]]:
    """Incremental variant of :func:`split_frame` for live streams:
    parse one framed message from the head of ``data`` ->
    ``(payload, total_consumed)``, or ``None`` when more bytes are
    needed — a reader off a socket cannot tell "short so far" from
    "short forever", so incompleteness must not be an error here.
    Raises ``ValueError`` only for a genuinely malformed length.
    Assumes the caller already matched the lead byte against a frame
    magic."""

    n = len(data)
    length = 0
    shift = 0
    pos = 1
    while True:
        if pos >= n:
            return None
        b = data[pos]
        pos += 1
        length |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
        if shift > 63:
            raise ValueError("malformed sweep frame length")
    if n < pos + length:
        return None
    return bytes(data[pos:pos + length]), pos + length


def split_frame(data: bytes) -> Tuple[bytes, int]:
    """Parse one framed message (magic + varint length + payload) from
    the head of ``data`` -> ``(payload, total_consumed)``.  Raises
    ``ValueError`` when incomplete/malformed (test/fake-agent helper;
    the production client reads the header incrementally off the
    socket)."""

    if not data or data[0] not in (SWEEP_FRAME_MAGIC, SWEEP_REQ_MAGIC):
        raise ValueError("not a sweep frame")
    length, pos = read_varint(data, 1)
    if pos + length > len(data):
        raise ValueError("truncated sweep frame")
    return bytes(data[pos:pos + length]), pos + length
