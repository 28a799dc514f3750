"""Backend registry.

Slice 1 of the port has one metrics source: the in-process CUDA backend
(:class:`.cuda.CudaBackend`).  A missing CUDA runtime surfaces as
:class:`~.base.LibraryNotFound`, the ``NVML_ERROR_LIBRARY_NOT_FOUND``
analog.
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
    """Construct a backend by name: ``cuda``, or None (= env
    ``TPUMON_BACKEND``, default ``cuda``)."""

    name = (name or os.environ.get("TPUMON_BACKEND") or "cuda").lower()
    if name == "cuda":
        from .cuda import CudaBackend
        return CudaBackend(**kwargs)
    raise BackendError(f"unknown backend {name!r} (this port knows: cuda)")
