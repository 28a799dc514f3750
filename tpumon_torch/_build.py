"""Build and bind the port's CUDA kernels, and build its native agent.

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

The native agent and its C client (``native/``: ``gpu-hostengine``,
``libtpumon_client.so``, ``tpumon-cdemo`` and the test binaries
``kmsg-classify`` and ``burst-fold``), the two CPython extensions
(``_tpumon_torch_codec``, the sweep-frame and burst codec, and
``_tpumon_torch_poll``, the epoll fleet poll engine) and their plain
smoke drivers (``codec-smoke``, ``poll-smoke``) build with the host's
``g++``/``cc`` under the reference's flags, at first use (:func:`native`),
into the same directory, each named by a hash of its sources and flags.
One file lock makes concurrent processes build once.  A failed build
raises: nothing falls back to the Python agent.  The extensions are
imported only from the build of the current sources
(:func:`load_extension`, which never compiles).

    python -m tpumon_torch._build --native    # build, print the paths
"""

from __future__ import annotations

import argparse
import ctypes
import fcntl
import hashlib
import importlib.util
import os
import shutil
import subprocess
import sys
import sysconfig
import threading
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

PKG_DIR = Path(__file__).resolve().parent
BUILD_DIR = PKG_DIR.parent / "build" / "tpumon_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
#: source -> its C entry points -> argument types (pointers, ints, the
#: softmax scale or learning rate, the stream); every entry returns
#: cudaGetLastError() as an int
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
    "csrc/sgd_update.cu": {
        "tpumon_sgd_update": (_P, _P, _P, _P, _I, _F, _P),
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


# -- the native agent and client (g++ / cc) ------------------------------------

NATIVE_DIR = PKG_DIR / "native"
#: the reference's native Makefile flags (-Werror on every target here)
CXXFLAGS = ("-O2", "-std=c++17", "-Wall", "-Wextra", "-Werror", "-fPIC")
CFLAGS = ("-O2", "-Wall", "-Wextra", "-Werror", "-fPIC")
#: the reference's waiver for its CPython extensions: PyTypeObject slots
#: are zero-initialized and filled in module init, which
#: -Wmissing-field-initializers flags by design
PY_WARN_WAIVER = ("-Wno-missing-field-initializers",)
#: the include path: the port's headers and its NVML ABI header, nothing of
#: the reference's tree and nothing of the CUDA toolkit
INCLUDES = ("-I", str(NATIVE_DIR / "include"), "-I", str(PKG_DIR / "testlib"),
            "-I", str(NATIVE_DIR / "agent"), "-I", str(NATIVE_DIR / "client"),
            "-I", str(NATIVE_DIR / "codec"), "-I", str(NATIVE_DIR / "poll"))


class NativeTarget:
    """One output: its compiler, main source, the files it depends on
    (globs under ``native/`` or the package) and its link arguments.  A
    CPython extension (``py_ext``) builds shared, against the
    interpreter's headers, and is named with its ``EXT_SUFFIX``."""

    def __init__(self, name: str, cxx: bool, main: str,
                 deps: Sequence[str], link: Sequence[str] = (),
                 after: Optional[str] = None, py_ext: bool = False) -> None:
        self.name, self.cxx, self.main = name, cxx, main
        self.deps, self.link, self.after = tuple(deps), tuple(link), after
        self.py_ext = py_ext

    def flags(self) -> Tuple[str, ...]:
        if self.py_ext:
            return CXXFLAGS + PY_WARN_WAIVER + (
                "-I", sysconfig.get_paths()["include"], "-shared")
        return CXXFLAGS if self.cxx else CFLAGS


_AGENT_DEPS = ("native/agent/*", "native/include/*.h", "testlib/nvml.h")
_CODEC_DEPS = ("native/codec/core.hpp", "native/codec/value.hpp")
_POLL_DEPS = _CODEC_DEPS + ("native/poll/engine.hpp",
                            "native/agent/json.hpp")
NATIVE_TARGETS: Dict[str, NativeTarget] = {t.name: t for t in (
    NativeTarget("gpu-hostengine", True, "native/agent/main.cc",
                 _AGENT_DEPS, ("-ldl", "-lpthread")),
    NativeTarget("libtpumon_client.so", True, "native/client/tpumon_client.cc",
                 ("native/client/tpumon_client.*", "native/agent/json.hpp",
                  "native/include/*.h"), ("-shared", "-lpthread")),
    NativeTarget("tpumon-cdemo", False, "native/client/tpumon_cdemo.c",
                 ("native/client/tpumon_cdemo.c",
                  "native/client/tpumon_client.h", "native/include/*.h"),
                 after="libtpumon_client.so"),
    NativeTarget("kmsg-classify", True, "native/testlib/kmsg_classify_main.cc",
                 ("native/testlib/kmsg_classify_main.cc",
                  "native/agent/kmsg.hpp")),
    NativeTarget("burst-fold", True, "native/testlib/burst_fold_main.cc",
                 ("native/testlib/burst_fold_main.cc",
                  "native/agent/sampler.hpp", "native/agent/source.hpp",
                  "native/include/*.h"), ("-lpthread",)),
    NativeTarget("_tpumon_torch_codec", True, "native/codec/module.cc",
                 _CODEC_DEPS + ("native/codec/py_common.hpp",), py_ext=True),
    NativeTarget("_tpumon_torch_poll", True, "native/poll/module.cc",
                 _POLL_DEPS + ("native/codec/py_common.hpp",), py_ext=True),
    NativeTarget("codec-smoke", True, "native/testlib/codec_smoke_main.cc",
                 _CODEC_DEPS, ("-lpthread",)),
    NativeTarget("poll-smoke", True, "native/testlib/poll_smoke_main.cc",
                 _POLL_DEPS, ("-lpthread",)),
)}

_native_lock = threading.Lock()
_native: Optional[Dict[str, Path]] = None


def native_digest(t: NativeTarget, after: Optional[Path] = None) -> str:
    """Hash of a target's sources (each by its path under the package),
    its flags and, for a program linked to a library of this build, that
    library's name."""

    h = hashlib.sha256()
    files = sorted({f for g in t.deps for f in PKG_DIR.glob(g)} |
                   {PKG_DIR / t.main})
    for f in files:
        h.update(str(f.relative_to(PKG_DIR)).encode() + b"\0" +
                 f.read_bytes())
    h.update(" ".join(t.flags() + t.link).encode())
    if after is not None:
        h.update(after.name.encode())
    return h.hexdigest()[:16]


def native_path(t: NativeTarget, digest: str) -> Path:
    if t.py_ext:
        suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
        return BUILD_DIR / f"{t.name}-{digest}{suffix}"
    stem, dot, ext = t.name.partition(".")
    return BUILD_DIR / (f"{stem}-{digest}{dot}{ext}")


def _compile_native(t: NativeTarget, after: Optional[Path]) -> Path:
    """One compiler run into ``build/tpumon_torch/<name>-<hash>``; a
    no-op when that file exists."""

    out = native_path(t, native_digest(t, after))
    if out.exists():
        return out
    cc = shutil.which("g++" if t.cxx else "cc") or shutil.which(
        "c++" if t.cxx else "gcc")
    if cc is None:
        raise RuntimeError(f"no {'C++' if t.cxx else 'C'} compiler on PATH: "
                           f"{t.name} cannot be built")
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cc, *t.flags(), *INCLUDES, "-o", str(tmp), str(PKG_DIR / t.main)]
    if t.name.endswith(".so") or t.py_ext:
        cmd += [f"-Wl,-soname,{out.name}"]
    if after is not None:
        cmd += [str(after), "-Wl,-rpath,$ORIGIN"]
    cmd += list(t.link)
    # the compiler runs while native() holds its build-once lock, on
    # purpose: every caller wants the finished file, the lock is what
    # makes the build happen once, and the wait ends with the compiler
    r = subprocess.run(  # tpumon-check: disable=blocking-while-locked
        cmd, capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cc} failed on {t.name} (exit {r.returncode}):\n"
                           f"$ {' '.join(cmd)}\n{(r.stdout + r.stderr)[-6000:]}")
    os.replace(tmp, out)
    return out


def native_build() -> Dict[str, Path]:
    """Build every native target (each a no-op when its hashed file
    exists), all compiler runs at once, under a file lock that makes
    concurrent processes build once; return name -> path."""

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            def chain(t: NativeTarget) -> Dict[str, Path]:
                got: Dict[str, Path] = {}
                after = None
                if t.after is not None:
                    after = got[t.after] = _compile_native(
                        NATIVE_TARGETS[t.after], None)
                got[t.name] = _compile_native(t, after)
                return got

            firsts = [t for t in NATIVE_TARGETS.values()
                      if not any(u.after == t.name
                                 for u in NATIVE_TARGETS.values())]
            out: Dict[str, Path] = {}
            with ThreadPoolExecutor(max_workers=len(firsts)) as pool:
                for got in pool.map(chain, firsts):
                    out.update(got)
            return out
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def native(name: Optional[str] = None):
    """The built native targets (name -> path), or the path of one;
    built on first call."""

    global _native
    with _native_lock:
        if _native is None:
            _native = native_build()
    return _native if name is None else _native[name]


def load_extension(name: str) -> Optional[types.ModuleType]:
    """Import the CPython extension target ``name`` from its build of the
    current sources, registered in ``sys.modules`` under ``name``; None
    when that build does not exist.  Never compiles, never looks anywhere
    else: a stale build (another hash) is not loaded.  Raises
    ``ImportError`` when the file does not import."""

    t = NATIVE_TARGETS[name]
    path = native_path(t, native_digest(t))
    if not path.exists():
        return None
    mod = sys.modules.get(name)
    if mod is not None and getattr(mod, "__file__", None) == str(path):
        return mod
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"{path} is not an extension module")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sys.modules[name] = mod
    return mod


def load_selected(name: str, what: str) -> Tuple[Optional[types.ModuleType],
                                                str]:
    """The extension ``name`` as ``TPUMON_NATIVE`` selects it -> (the
    module or None, why None): ``0`` never loads it, ``1`` raises
    ``ImportError`` unless the build of the current sources loads, unset
    (or anything else) loads it when that build exists.  ``what`` names
    it in the messages."""

    forced = os.environ.get("TPUMON_NATIVE", "").strip()
    if forced == "0":
        return None, "disabled by TPUMON_NATIVE=0"
    error = ""
    try:
        mod = load_extension(name)
    except ImportError as e:
        mod, error = None, f"the built extension failed to load: {e}"
    if mod is None:
        if forced == "1":
            raise ImportError(
                f"TPUMON_NATIVE=1 but the {what} is not built for these "
                f"sources; build it with `python -m tpumon_torch._build "
                f"--native` ({error or 'not built'})")
        error = error or ("extension not built (python -m "
                          "tpumon_torch._build --native)")
    return mod, error


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python -m tpumon_torch._build",
                                description=__doc__.splitlines()[0])
    p.add_argument("--native", action="store_true",
                   help="build the native agent, client, codec and poll "
                   "engine; print the paths")
    args = p.parse_args(argv)
    if args.native:
        for name, path in native().items():
            print(f"{name} {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
