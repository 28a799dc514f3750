"""REST API service — HTTP access to the full monitoring surface.

The port's copy of ``tpumon/restapi/``.

Analog of the reference's restApi sample (``samples/dcgm/restApi/``,
SURVEY §2.6): every endpoint has a plain-text rendering and a ``/json``
twin, devices are addressable by index and by UUID, and the daemon
self-reports via a status endpoint.
"""
