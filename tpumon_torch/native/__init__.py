"""The port's native agent and C client: ``gpu-hostengine``
(``agent/``), ``libtpumon_client.so`` and ``tpumon-cdemo`` (``client/``),
built by :mod:`tpumon_torch._build` at first use."""
