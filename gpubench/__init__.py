"""The benchmark of ``tpumon_torch`` on an NVIDIA H100: one monitored node
as deployed, run one cell at a time (``python3 -m gpubench.run``)."""
