"""Build and bind the port's CUDA kernels.

One ``nvcc`` run per source file compiles each of ``csrc/*.cu`` for
``sm_90a`` into a shared library with a plain C interface under
``build/tpumon_torch/`` at the repository root, named by a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header never loads a stale library.
The runs start together, one thread each.  The libraries are loaded with
:mod:`ctypes` and their entry points gathered into one namespace;
nothing includes PyTorch's headers, which keeps a cold build to seconds.

The build runs at first use (:func:`load`), never at import: the CPU
tests import every module on hosts without ``nvcc``.  A failed build
raises; nothing falls back to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

PKG_DIR = Path(__file__).resolve().parent
BUILD_DIR = PKG_DIR.parent / "build" / "tpumon_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
#: source -> its C entry points -> argument types (pointers, ints, the
#: softmax scale, the stream); every entry returns cudaGetLastError() as
#: an int
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "csrc/flash_attn.cu": {
        "tpumon_flash_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
        "tpumon_flash_bwd_dq": (_P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _F, _P),
        "tpumon_flash_bwd_dkv": (_P, _P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _F, _P),
    },
    "csrc/load_kernels.cu": {
        "tpumon_mxu_burn": (_P, _P, _P, _I, _I, _P),
        "tpumon_hbm_stream": (_P, _P, _L, _P),
    },
}
SOURCES = tuple(SIGNATURES)

_lock = threading.Lock()
_lib: Optional[types.SimpleNamespace] = None


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's conventional install prefix."""

    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the port's CUDA kernels cannot be built")


def source_digest(src: Path) -> str:
    """Hash of ``src``, every header beside it (``csrc/*.cuh``, which any
    source may include) and the flags: the name of its library."""

    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _compile(src: Path) -> Path:
    """One nvcc run: ``src`` -> ``build/tpumon_torch/<stem>_<hash>.so``,
    with ptxas's register/shared-memory report kept beside it."""

    digest = source_digest(src)
    out = BUILD_DIR / f"lib{src.stem}_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    log = f"$ {' '.join(cmd)}\n{r.stdout}{r.stderr}"
    out.with_suffix(".log").write_text(log)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src.name} "
                           f"(exit {r.returncode}):\n{log[-6000:]}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def build() -> List[Path]:
    """Compile every source, all ``nvcc`` runs at once (each a no-op when
    its hashed library exists), and return the library paths in the
    order of :data:`SOURCES`.  The first failure raises."""

    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        futures = [pool.submit(_compile, PKG_DIR / s) for s in SOURCES]
        return [f.result() for f in futures]


def build_log() -> str:
    """ptxas's report from the last build of every library (registers,
    shared memory, spills per kernel), or '' before any build."""

    logs = [p.with_suffix(".log") for p in build()]
    return "".join(p.read_text() for p in logs if p.exists())


def load() -> types.SimpleNamespace:
    """Every C entry point of every library, bound and typed, as
    attributes of one namespace; built on first call."""

    global _lib
    with _lock:
        if _lib is None:
            fns = {}
            for src, path in zip(SOURCES, build()):
                lib = ctypes.CDLL(str(path))
                for name, argtypes in SIGNATURES[src].items():
                    fn = getattr(lib, name)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                    fns[name] = fn
            _lib = types.SimpleNamespace(**fns)
        return _lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""

    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
