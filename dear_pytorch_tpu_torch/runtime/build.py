"""Build and load the native input-pipeline library — the port of
``dear_pytorch_tpu/runtime/build.py``.

``csrc/dear_runtime.cpp`` (the port's byte-identical copy of the JAX
package's producer source, so the package stands alone) is compiled with
the system C++ toolchain at first use, with the JAX package's build command
(``g++ -O2 -std=c++17 -shared -fPIC -pthread``), into ``build/runtime/``
at the root of the checkout (listed in ``.gitignore``), under a sha256 tag
of the source, and loaded with ``ctypes`` (a plain C ABI; no pybind11).
Nothing is built when a module is imported. Thread-safe. When the build or
the load fails, `load` returns None and `load_error` says why; the
pipeline's caller decides what that means (`runtime.pipeline.Pipeline`
falls back to `NumpyPipeline`, as JAX's does; ``--pipeline native``
refuses).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

__all__ = ["BUILD_DIR", "KIND_BERNOULLI_MASKED_I32", "KIND_CONST_I32",
           "KIND_NORMAL_F32", "KIND_UNIFORM_F32", "KIND_UNIFORM_I32",
           "SOURCE", "Segment", "library_path", "load", "load_error"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_load_error: Optional[str] = None

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "dear_runtime.cpp"
BUILD_DIR = _PKG.parent / "build" / "runtime"
#: the JAX package's build command (its build.py:63-64), before source and
#: output
CXX_CMD = ("g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")


class Segment(ctypes.Structure):
    """Mirror of the C Segment struct (csrc/dear_runtime.cpp)."""

    _fields_ = [
        ("offset", ctypes.c_uint64),
        ("count", ctypes.c_uint64),
        ("kind", ctypes.c_int32),
        ("p0", ctypes.c_double),
        ("p1", ctypes.c_double),
    ]


KIND_NORMAL_F32 = 0
KIND_UNIFORM_I32 = 1
KIND_CONST_I32 = 2
KIND_UNIFORM_F32 = 3
KIND_BERNOULLI_MASKED_I32 = 4


def library_path() -> Path:
    """Where the library of the current source is built: its file name
    carries the first 12 hex digits of the source's sha256."""
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"dear_runtime_{tag}.so"


def _compile(force: bool = False) -> Optional[Path]:
    global _load_error
    if not SOURCE.exists():
        _load_error = f"source missing: {SOURCE}"
        return None
    so = library_path()
    if so.exists() and not force:
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([*CXX_CMD, str(SOURCE), "-o", str(tmp)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so)   # atomic: no process loads a half-written file
        return so
    except (OSError, subprocess.SubprocessError) as exc:
        detail = getattr(exc, "stderr", b"") or b""
        _load_error = (f"compile failed: {exc} "
                       f"{detail.decode(errors='replace')[-500:]}").strip()
        return None


def _is_loader_mismatch(exc: OSError) -> bool:
    """A dlopen failure caused by a stale cached binary (linked against
    another libc/libstdc++), recoverable by recompiling from source."""
    s = str(exc)
    return ("GLIBC" in s or "GLIBCXX" in s or "version `" in s
            or "invalid ELF header" in s or "wrong ELF class" in s)


def load_error() -> Optional[str]:
    """Why the native library is unavailable (None when it loaded, or no
    load was tried)."""
    return _load_error


def _dlopen(so: Path) -> Optional[ctypes.CDLL]:
    """CDLL, recompiling once on a loader mismatch of the cached file."""
    global _load_error
    try:
        return ctypes.CDLL(str(so))
    except OSError as exc:
        if not _is_loader_mismatch(exc):
            _load_error = f"dlopen failed: {exc}"
            return None
        rebuilt = _compile(force=True)
        if rebuilt is None:
            _load_error = (_load_error
                           or f"loader mismatch, rebuild failed: {exc}")
            return None
        try:
            lib = ctypes.CDLL(str(rebuilt))
        except OSError as exc2:
            _load_error = f"loader mismatch persists after rebuild: {exc2}"
            return None
        _load_error = None
        return lib


def load() -> Optional[ctypes.CDLL]:
    """The native library (built first if needed), or None when it cannot
    be built or loaded (`load_error`)."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        so = _compile()
        if so is None:
            return None
        lib = _dlopen(so)
        if lib is None:
            return None
        lib.dear_now_ns.restype = ctypes.c_uint64
        lib.dear_pipeline_create.restype = ctypes.c_void_p
        lib.dear_pipeline_create.argtypes = [
            ctypes.c_uint64, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
            ctypes.POINTER(Segment), ctypes.c_int,
        ]
        lib.dear_pipeline_acquire.restype = ctypes.c_int
        lib.dear_pipeline_acquire.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
        ]
        lib.dear_pipeline_release.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.dear_pipeline_produced.restype = ctypes.c_uint64
        lib.dear_pipeline_produced.argtypes = [ctypes.c_void_p]
        lib.dear_pipeline_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib
