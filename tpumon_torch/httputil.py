"""Shared minimal HTTP plumbing for the exporter, pod exporter and REST API.

The port's copy of ``tpumon/httputil.py``, with request spans: a server
given a :class:`tpumon_torch.spans.Recorder` records each request to one
of the :data:`TIMED_PATHS` as a ``request`` root from the moment ``accept``
returned (stamped on the serving thread) with three children: ``wait``
(accepted to ``do_GET`` entered: the handler thread's start, the
interpreter lock, the request's headers), ``payload`` (the dispatch) and
``write`` (the headers and the body to the socket).

One implementation of the serve-text pattern all three daemons need:
dispatch on the path (query string stripped), write Content-Type/Length,
quiet logs, daemon serve thread with clean shutdown.

Dispatch contract (kept intentionally loose so the exporter's zero-copy
serve path needs no second server class):

* signature — ``dispatch(path)`` or ``dispatch(path, headers)``; a
  two-parameter dispatch additionally receives the request headers
  (the exporter uses ``Accept-Encoding`` to pick its pre-compressed
  gzip buffer).  The arity is inspected once at construction.
* return — ``(status, content_type, body)`` or
  ``(status, content_type, body, extra_headers)`` where
  ``extra_headers`` is a ``{name: value}`` map (e.g.
  ``Content-Encoding``); ``body`` may be ``str`` or pre-encoded
  ``bytes`` — bytes are written as-is, with no per-request encode.
"""

from __future__ import annotations

import inspect
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

from . import spans as _spans

#: minimal dispatch signature: path (no query string) -> (status,
#: content_type, body); see the module docstring for the extended forms
Dispatch = Callable[..., Tuple[Any, ...]]

_QVALUE = re.compile(r"q\s*=\s*([0-9]+(?:\.[0-9]*)?)")

#: the paths whose requests a server given spans records
TIMED_PATHS = ("/metrics", "/tpu/metrics")


def accepts_gzip(header: Optional[str]) -> bool:
    """True when an ``Accept-Encoding`` value admits gzip (q > 0).

    Per RFC 9110 §12.5.3 a ``*`` member matches any coding not named
    elsewhere in the field, so ``Accept-Encoding: *`` (with q > 0)
    admits gzip too; an explicit ``gzip`` member always wins over
    ``*``.  Minimal on purpose beyond that: the exporter only needs to
    decide between its two pre-built buffers, so identity fallback is
    always acceptable."""

    if not header:
        return False
    star: Optional[bool] = None
    for part in header.split(","):
        token, _, params = part.partition(";")
        tok = token.strip().lower()
        if tok == "gzip":
            m = _QVALUE.search(params)
            return m is None or float(m.group(1)) > 0.0
        if tok == "*" and star is None:
            m = _QVALUE.search(params)
            star = m is None or float(m.group(1)) > 0.0
    return bool(star)


class _StampingServer(ThreadingHTTPServer):
    """Stamps each connection (``time.monotonic_ns``) as ``accept``
    returns, on the serving thread; its handler takes the stamp."""

    def __init__(self, *args: Any) -> None:
        super().__init__(*args)
        self.accepted: Dict[Any, int] = {}

    def get_request(self):
        sock, addr = super().get_request()
        self.accepted[sock] = time.monotonic_ns()
        return sock, addr


class TextHTTPServer:
    def __init__(self, dispatch: Dispatch, port: int, bind: str = "",
                 spans: Optional[_spans.Recorder] = None) -> None:
        dispatch_ref = dispatch
        try:
            wants_headers = len(
                inspect.signature(dispatch).parameters) >= 2
        except (TypeError, ValueError):  # builtins/partials: assume legacy
            wants_headers = False

        class Handler(BaseHTTPRequestHandler):
            def setup(self) -> None:
                self.accepted_ns = self.server.accepted.pop(self.request,
                                                            None)
                super().setup()

            def do_GET(self) -> None:
                entered = time.monotonic_ns()
                path = self.path.split("?", 1)[0]
                if spans is None or path not in TIMED_PATHS:
                    self._serve(path)
                    return
                with spans.root("request",
                                self.accepted_ns or entered) as req:
                    if self.accepted_ns is not None:
                        req.add("wait", self.accepted_ns, entered)
                    self._serve(path)

            def _serve(self, path: str) -> None:
                extra: Optional[Mapping[str, str]] = None
                with _spans.span("payload"):
                    try:
                        if wants_headers:
                            result = dispatch_ref(path, self.headers)
                        else:
                            result = dispatch_ref(path)
                        if len(result) == 4:
                            code, ctype, body, extra = result
                        else:
                            code, ctype, body = result
                    except Exception as e:  # route errors -> 500, not a dead conn
                        code, ctype, body = 500, "text/plain", f"error: {e}\n"
                        extra = None
                    data: Union[bytes, bytearray]
                    if isinstance(body, str):
                        data = body.encode()
                    else:
                        data = body  # pre-encoded: served as-is, zero copies
                with _spans.span("write"):
                    self.send_response(code)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(data)))
                    if extra:
                        for name, value in extra.items():
                            self.send_header(name, value)
                    self.end_headers()
                    self.wfile.write(data)

            def log_message(self, *args: Any) -> None:
                pass

        self.server = _StampingServer((bind, port), Handler)
        self.port = self.server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        name="tpumon-http", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        # a raising shutdown() must still close the listening socket,
        # and a raising server_close() must still reap the serve
        # thread: teardown aggregates member by member.  shutdown()
        # only runs when the serve thread is live — on a never-started
        # (or start-failed) server it would wait forever for a
        # serve_forever loop that never ran
        try:
            if self._thread is not None and self._thread.is_alive():
                self.server.shutdown()
        finally:
            try:
                self.server.server_close()
            finally:
                if self._thread is not None:
                    self._thread.join(timeout=5.0)
