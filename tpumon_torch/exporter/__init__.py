"""The Prometheus exporter: the sweep core of ``tpumon.exporter``, ported.

A per-host sweep emitting ``tpu_*`` metric families to an atomically
renamed textfile.  The HTTP endpoint and the optional planes come in
later slices.
"""
