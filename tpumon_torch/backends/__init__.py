"""Backend registry and auto-detection.

Two metrics sources: the out-of-band NVML backend
(:class:`.nvml.NvmlBackend`, the counterpart of the reference's
``libtpu``), and the in-process CUDA backend (:class:`.cuda.CudaBackend`,
the counterpart of ``pjrt``) for a monitor embedded in the workload; and
the deterministic fake (:class:`.fake.FakeBackend`, the reference's,
``TPUMON_FAKE_PRESET`` naming a topology preset), built only when named.
``auto`` picks NVML, and never the in-process backend unless
``TPUMON_ALLOW_INPROCESS=1``: it would initialize CUDA in the monitor's
process.  ``auto`` never picks the fake.  A missing source surfaces as :class:`~.base.LibraryNotFound`,
the ``NVML_ERROR_LIBRARY_NOT_FOUND`` analog, so a host without a GPU
degrades cleanly.
"""

from __future__ import annotations

import os
from typing import Optional

from .base import Backend, BackendError, ChipNotFound, LibraryNotFound

__all__ = [
    "Backend", "BackendError", "ChipNotFound", "LibraryNotFound",
    "make_backend",
]


def make_backend(name: Optional[str] = None, **kwargs) -> Backend:
    """Construct a backend by name: ``nvml``, ``cuda``, ``fake``, ``auto``
    or None (= env ``TPUMON_BACKEND``, default ``auto``).  ``auto`` returns
    an opened backend."""

    name = (name or os.environ.get("TPUMON_BACKEND") or "auto").lower()
    if name == "fake":
        from .fake import FakeBackend, FakeSliceConfig
        cfg = kwargs.pop("config", None)
        preset = os.environ.get("TPUMON_FAKE_PRESET", "")
        if cfg is None and preset:
            factory = getattr(FakeSliceConfig, preset, None)
            cfg = factory() if factory else None
        return FakeBackend(config=cfg, **kwargs)
    if name == "nvml":
        from .nvml import NvmlBackend
        return NvmlBackend(**kwargs)
    if name == "cuda":
        from .cuda import CudaBackend
        return CudaBackend(**kwargs)
    if name == "auto":
        candidates = ["nvml"]
        if os.environ.get("TPUMON_ALLOW_INPROCESS") == "1":
            candidates.append("cuda")
        errors = []
        for candidate in candidates:
            try:
                b = make_backend(candidate, **kwargs)
                b.open()
                if b.chip_count() == 0:
                    # NVML initializes on a host with no GPU; auto wants a
                    # usable source, so fall through (an explicit nvml
                    # still serves the empty inventory)
                    b.close()
                    errors.append(f"{candidate}: opened with zero devices")
                    continue
                return b
            except (LibraryNotFound, BackendError, ImportError) as e:
                errors.append(f"{candidate}: {e}")
        raise LibraryNotFound("no GPU metrics source found on this host; "
                              "tried: " + "; ".join(errors))
    raise BackendError(f"unknown backend {name!r} (this port knows: nvml, "
                       f"cuda, fake, auto)")
