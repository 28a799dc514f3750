"""Loader for the port's native codec extension (``_tpumon_torch_codec``).

The shared codec core (sweep-frame encode/decode, burst fold) has a
C++ twin built as a CPython extension (``native/codec/``; built by
``python -m tpumon_torch._build --native``).  When it is loaded,
:mod:`tpumon_torch.sweepframe` and :mod:`tpumon_torch.burst` dispatch to
it: the native handles own the delta table / mirror and release the GIL
around every encode/decode/fold, so in-process shard threads run in
parallel.  When it is not, the pure-Python implementations serve
(identical bytes, held to each other and to the JAX package's by
``tests/test_torch_codec_native.py``).

Only the build of the current sources is loaded
(:func:`tpumon_torch._build.load_extension`: the file named by the hash
of the sources and flags under ``build/tpumon_torch/``): a stale build is
never loaded, nothing is compiled here, and no module is imported off
``sys.path``.  The extension's module name is the port's own, so it
never shadows the JAX package's ``_tpumon_codec`` in one process.

Env override ``TPUMON_NATIVE``:

* ``0`` — never load the extension (force the pure-Python plane);
* ``1`` — fail loudly (ImportError) if the extension is not built or
  is rejected;
* unset/other — load it when it is built, fall back silently otherwise.

``reject()`` lets the facades refuse a loaded extension whose compiled
wire constants disagree with the Python declarations — a stale build
must degrade to the Python plane, never emit drifted bytes.
"""

from __future__ import annotations

import os
from typing import Any, Optional

from . import _build

#: the extension's module (and build target) name
NAME = "_tpumon_torch_codec"
_FORCED = os.environ.get("TPUMON_NATIVE", "").strip()
#: the loaded extension module, or None (pure-Python fallback), and the
#: human-readable reason when it is None (for logs / self-metrics)
lib: Optional[Any]
error: str


def active() -> bool:
    """True when the native codec backs the facades (the value of the
    ``tpumon_codec_native`` self-metric gauge)."""

    return lib is not None


def reject(reason: str) -> None:
    """Refuse the loaded extension (constant mismatch): fall back to
    the pure-Python plane, or raise when ``TPUMON_NATIVE=1``."""

    global lib, error
    if _FORCED == "1":
        raise ImportError(f"TPUMON_NATIVE=1 but the native codec was "
                          f"rejected: {reason}")
    lib = None
    error = reason


lib, error = _build.load_selected(NAME, "native codec extension")
