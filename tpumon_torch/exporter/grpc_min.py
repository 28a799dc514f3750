"""Minimal gRPC unary-call client over a unix socket — stdlib only.

The port's copy of ``tpumon/exporter/grpc_min.py``, unchanged but for
this paragraph.

The kubelet pod-resources API (``kubelet_server.go:20-53``) is one unary
RPC on a local unix socket.  Round 1 used the ``grpc`` package for
transport, which costs ~14 MB RSS and is the Python exporter's heaviest
dependency; this module speaks just enough HTTP/2 (RFC 7540) + gRPC
framing to make that one call:

* client connection preface, SETTINGS exchange (+ acks), PING acks;
* one request stream: HEADERS (HPACK: static-table indexes and literals
  without indexing — no dynamic table, no huffman) + DATA carrying the
  5-byte gRPC frame;
* response: DATA frames accumulated into one gRPC message;
  WINDOW_UPDATEs granted up front for the 16 MB response cap
  (kubelet_server.go:16-18);
* trailers: minimal HPACK scan for ``grpc-status`` when the server sends
  it as a literal; absence of a response message is an error either way.

Scope is deliberately narrow: unary, cleartext, unix socket, response
sizes within the granted window.  The protobuf codec lives in
``podresources.py`` (hand-rolled there since round 1) — this is only the
wire under it.
"""

from __future__ import annotations

import socket
import struct
from typing import Dict, Optional, Tuple

_PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

# frame types (RFC 7540 §6)
_DATA = 0x0
_HEADERS = 0x1
_RST_STREAM = 0x3
_SETTINGS = 0x4
_PING = 0x6
_GOAWAY = 0x7
_WINDOW_UPDATE = 0x8

_FLAG_END_STREAM = 0x1
_FLAG_END_HEADERS = 0x4
_FLAG_ACK = 0x1

#: connection/stream-level extra receive window we grant (the kubelet cap)
_WINDOW_BYTES = 16 * 1024 * 1024


class GrpcError(RuntimeError):
    pass


def _frame(ftype: int, flags: int, stream_id: int, payload: bytes) -> bytes:
    return struct.pack("!I", len(payload))[1:] + bytes(
        (ftype, flags)) + struct.pack("!I", stream_id) + payload


def _hpack_int(value: int, prefix_bits: int, first_byte: int) -> bytes:
    """HPACK integer encoding (RFC 7541 §5.1) with the pattern bits of
    ``first_byte`` preserved."""

    limit = (1 << prefix_bits) - 1
    if value < limit:
        return bytes((first_byte | value,))
    out = bytearray((first_byte | limit,))
    value -= limit
    while value >= 0x80:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def _hpack_str(s: bytes) -> bytes:
    return _hpack_int(len(s), 7, 0x00) + s  # no huffman


def _literal_indexed_name(index: int, value: bytes) -> bytes:
    # literal header field without indexing, indexed name (§6.2.2)
    return _hpack_int(index, 4, 0x00) + _hpack_str(value)


def _literal_new_name(name: bytes, value: bytes) -> bytes:
    return b"\x00" + _hpack_str(name) + _hpack_str(value)


def _request_headers(path: str, authority: str) -> bytes:
    # static table: 3 = :method POST, 6 = :scheme http, 4 = :path /,
    # 1 = :authority, 31 = content-type
    # reachable from the sweep via pod attribution, but runs once per
    # kubelet REFRESH (the attributor caches its device map), never
    # per sweep
    return (b"\x83\x86" +
            _literal_indexed_name(4, path.encode()) +  # tpumon-check: disable=hot-encode
            _literal_indexed_name(1, authority.encode()) +  # tpumon-check: disable=hot-encode
            _literal_indexed_name(31, b"application/grpc") +
            _literal_new_name(b"te", b"trailers"))


def _hpack_scan_status(block: bytes) -> Optional[int]:
    """Best-effort ``grpc-status`` extraction from a trailer block.

    Handles the common encodings (literal with/without indexing, new
    name, no huffman on the value).  Returns None when the trailer uses
    encodings outside that set — callers treat the presence of a
    well-formed response message as success in that case.
    """

    i = block.find(b"grpc-status")
    if i < 0:
        return None
    j = i + len(b"grpc-status")
    if j >= len(block):
        return None
    vlen = block[j] & 0x7F
    if block[j] & 0x80:  # huffman-coded value: 0..9 code would be odd; skip
        return None
    val = block[j + 1: j + 1 + vlen]
    try:
        return int(val.decode())
    except ValueError:
        return None


class _Conn:
    def __init__(self, sock: socket.socket) -> None:
        self._s = sock
        self._buf = b""

    def send(self, data: bytes) -> None:
        self._s.sendall(data)

    def read_frame(self) -> Tuple[int, int, int, bytes]:
        while len(self._buf) < 9:
            chunk = self._s.recv(65536)
            if not chunk:
                raise GrpcError("connection closed mid-frame")
            self._buf += chunk
        length = int.from_bytes(self._buf[:3], "big")
        ftype = self._buf[3]
        flags = self._buf[4]
        stream_id = int.from_bytes(self._buf[5:9], "big") & 0x7FFFFFFF
        while len(self._buf) < 9 + length:
            chunk = self._s.recv(65536)
            if not chunk:
                raise GrpcError("connection closed mid-frame")
            self._buf += chunk
        payload = self._buf[9:9 + length]
        self._buf = self._buf[9 + length:]
        return ftype, flags, stream_id, payload


def unary_call(socket_path: str, path: str, request: bytes,
               timeout_s: float = 10.0,
               authority: str = "localhost") -> bytes:
    """One gRPC unary call; returns the response message bytes."""

    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(timeout_s)
    try:
        s.connect(socket_path)
        conn = _Conn(s)
        # preface + our SETTINGS + a big connection window up front
        conn.send(_PREFACE)
        conn.send(_frame(_SETTINGS, 0, 0,
                         # SETTINGS_INITIAL_WINDOW_SIZE (0x4) = 16 MB:
                         # covers the per-stream window for the response
                         struct.pack("!HI", 0x4, _WINDOW_BYTES)))
        conn.send(_frame(_WINDOW_UPDATE, 0, 0,
                         struct.pack("!I", _WINDOW_BYTES)))
        conn.send(_frame(_HEADERS, _FLAG_END_HEADERS, 1,
                         _request_headers(path, authority)))
        grpc_msg = b"\x00" + struct.pack("!I", len(request)) + request
        conn.send(_frame(_DATA, _FLAG_END_STREAM, 1, grpc_msg))

        body = b""
        grpc_status: Optional[int] = None
        got_headers = False
        while True:
            ftype, flags, stream_id, payload = conn.read_frame()
            if ftype == _SETTINGS:
                if not flags & _FLAG_ACK:
                    conn.send(_frame(_SETTINGS, _FLAG_ACK, 0, b""))
                continue
            if ftype == _PING:
                if not flags & _FLAG_ACK:
                    conn.send(_frame(_PING, _FLAG_ACK, 0, payload))
                continue
            if ftype == _WINDOW_UPDATE:
                continue
            if ftype == _GOAWAY:
                code = int.from_bytes(payload[4:8], "big") if \
                    len(payload) >= 8 else -1
                raise GrpcError(f"server GOAWAY (error code {code})")
            if ftype == _RST_STREAM and stream_id == 1:
                code = int.from_bytes(payload[:4], "big") if payload else -1
                raise GrpcError(f"stream reset (error code {code})")
            if stream_id != 1:
                continue
            if ftype == _HEADERS:
                if got_headers:  # trailers
                    st = _hpack_scan_status(payload)
                    if st is not None:
                        grpc_status = st
                else:
                    got_headers = True
                    st = _hpack_scan_status(payload)
                    if st is not None:
                        grpc_status = st  # trailers-only response
                if flags & _FLAG_END_STREAM:
                    break
                continue
            if ftype == _DATA:
                body += payload
                if flags & _FLAG_END_STREAM:
                    break
                continue
        if grpc_status not in (None, 0):
            raise GrpcError(f"grpc-status {grpc_status}")
        if len(body) < 5:
            raise GrpcError(
                f"no response message (grpc-status {grpc_status})")
        if body[0] != 0:
            raise GrpcError("compressed response not supported")
        mlen = int.from_bytes(body[1:5], "big")
        msg = body[5:5 + mlen]
        if len(msg) != mlen:
            raise GrpcError("truncated response message")
        return msg
    finally:
        s.close()
