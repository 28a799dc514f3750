"""The Prometheus exporter: ``tpumon.exporter``, ported.

A per-host sweep emitting ``tpu_*`` metric families to an atomically
renamed textfile and a native HTTP ``/metrics`` endpoint
(:mod:`.exporter`, :mod:`.main`), with the textfile-collector merge of
workload drop files and Kubernetes pod attribution from the kubelet
pod-resources socket (:mod:`.pod_attrib`, :mod:`.pod_main`).
"""
