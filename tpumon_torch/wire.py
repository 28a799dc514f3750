"""Shared minimal protobuf wire reader *and writer*.

The port's copy of ``tpumon/wire.py``, unchanged but for this docstring.
Hand-rolled protobuf instead of vendored generated stubs (the reference
vendors the whole k8s client for one message type, ``vendor.conf:1-10``):
the kubelet pod-resources codec (:mod:`tpumon_torch.exporter.podresources`)
decodes from this one wire walker, and the flight recorder's and the
stream plane's sweep-frame codecs, when ported, use the writer half too,
so low-level behavior (varint masking, truncation errors, wire types)
cannot drift between them.

Semantics, chosen to match standard protobuf decoders:

* varints are masked to 64 bits (a garbage high byte must not abort the
  message) and capped at 10 bytes;
* truncation raises ``ValueError`` — callers decide whether that is
  fatal (kubelet RPC: yes) or droppable (one plane of a trace: no);
* unknown wire types raise ``ValueError`` (nothing after them can be
  framed).
"""

from __future__ import annotations

import struct
from typing import Iterator, Tuple, Union

_MASK64 = (1 << 64) - 1


def read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    """Decode one varint at ``pos`` -> (value, new_pos)."""

    result = 0
    shift = 0
    start = pos
    while True:
        if pos >= len(data):
            raise ValueError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result & _MASK64, pos
        shift += 7
        if pos - start >= 10:
            raise ValueError("varint too long")


def iter_fields(data: bytes) -> Iterator[Tuple[int, int, Union[int, bytes]]]:
    """Yield ``(field_number, wire_type, value)`` over one message.

    ``value`` is an int for varint (wt 0) and fixed32/64 (wt 5/1,
    little-endian unsigned), ``bytes`` for length-delimited (wt 2).

    Hot path (the xplane event loop walks tens of thousands of these
    per capture, under GIL contention with a live workload): varints
    are decoded inline with a single-byte fast path instead of calling
    :func:`read_varint` per field — semantics identical (64-bit mask,
    10-byte cap, same truncation errors), pinned by a differential
    test against the callable reference (`tests/test_xplane.py`).
    """

    pos = 0
    n = len(data)
    while pos < n:
        # -- key varint, inlined --
        b = data[pos]
        if b < 0x80:
            key = b
            pos += 1
        else:
            key = 0
            shift = 0
            start = pos
            while True:
                if pos >= n:
                    raise ValueError("truncated varint")
                b = data[pos]
                pos += 1
                key |= (b & 0x7F) << shift
                if not b & 0x80:
                    key &= _MASK64
                    break
                shift += 7
                if pos - start >= 10:
                    raise ValueError("varint too long")
        field_no, wire = key >> 3, key & 0x07
        if wire == 2:  # length-delimited
            if pos >= n:
                raise ValueError("truncated varint")
            b = data[pos]
            if b < 0x80:
                length = b
                pos += 1
            else:
                length, pos = read_varint(data, pos)
            if pos + length > n:
                raise ValueError("truncated field")
            yield field_no, wire, data[pos:pos + length]
            pos += length
        elif wire == 0:  # varint, inlined
            v = 0
            shift = 0
            start = pos
            while True:
                if pos >= n:
                    raise ValueError("truncated varint")
                b = data[pos]
                pos += 1
                v |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
                if pos - start >= 10:
                    raise ValueError("varint too long")
            yield field_no, wire, v & _MASK64
        elif wire == 5:  # fixed32
            if pos + 4 > n:
                raise ValueError("truncated fixed32")
            yield field_no, wire, int.from_bytes(data[pos:pos + 4], "little")
            pos += 4
        elif wire == 1:  # fixed64
            if pos + 8 > n:
                raise ValueError("truncated fixed64")
            yield field_no, wire, int.from_bytes(data[pos:pos + 8], "little")
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")


# -- writer (encoder counterpart of the walker above) --------------------------
#
# Appends into a caller-owned ``bytearray`` — the sweep-frame hot path
# builds one frame from many nested submessages, and returning ``bytes``
# per field would copy every level once more.  Values are masked to 64
# bits like the reader; negative ints must be zigzag-encoded first
# (:func:`zigzag_encode`), matching standard proto sint64.

def write_varint(out: bytearray, value: int) -> None:
    """Append one varint (canonical, minimal-length encoding)."""

    v = value & _MASK64
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def write_tag(out: bytearray, field_no: int, wire_type: int) -> None:
    """Append a field key (``field_no << 3 | wire_type``)."""

    write_varint(out, (field_no << 3) | wire_type)


def write_varint_field(out: bytearray, field_no: int, value: int) -> None:
    """Append a wire-type-0 field."""

    write_tag(out, field_no, 0)
    write_varint(out, value)


def write_bytes_field(out: bytearray, field_no: int,
                      payload: Union[bytes, bytearray]) -> None:
    """Append a length-delimited (wire-type-2) field."""

    write_tag(out, field_no, 2)
    write_varint(out, len(payload))
    out += payload


def write_double_field(out: bytearray, field_no: int, value: float) -> None:
    """Append a fixed64 field holding IEEE-754 double bits
    (little-endian, the protobuf ``double`` convention; read back with
    :func:`decode_double_bits` on the walker's int value)."""

    write_tag(out, field_no, 1)
    out += struct.pack("<d", value)


def decode_double_bits(bits: int) -> float:
    """The double behind a fixed64 value yielded by :func:`iter_fields`."""

    return struct.unpack("<d", bits.to_bytes(8, "little"))[0]  # type: ignore[no-any-return]


def zigzag_encode(value: int) -> int:
    """Signed int -> unsigned varint payload (proto sint64 zigzag)."""

    return ((value << 1) ^ (value >> 63)) & _MASK64


def zigzag_decode(value: int) -> int:
    """Unsigned varint payload -> signed int (inverse of
    :func:`zigzag_encode`)."""

    return (value >> 1) ^ -(value & 1)
