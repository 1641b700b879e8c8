"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

The sources have a plain C interface and include no PyTorch header, so
``nvcc`` compiles them into one shared library in seconds; ``ctypes`` binds
it.  The library is built from the package's own sources at first use,
into ``.build/`` beside this file, under a name keyed by a hash of the
sources and flags, so a changed source is rebuilt and an unchanged one is
reused.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SOURCES = ("scatter.cu", "sweep.cu")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_HERE = Path(__file__).resolve().parent
_CSRC = _HERE / "csrc"
_BUILD = _HERE / ".build"

_P = ctypes.c_void_p
_I = ctypes.c_longlong
#: C entry -> argtypes; every pointer and the stream as c_void_p
_SIGNATURES = {
    "sos_scatter_f32": [_P] * 7 + [_I] * 3 + [_P],
    "sos_scatter_f64": [_P] * 7 + [_I] * 3 + [_P],
    "sos_sweep_f32": [_P] * 7 + [_I] * 4 + [_P],
    "sos_sweep_f64": [_P] * 7 + [_I] * 4 + [_P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "radiativetransfer_sos_torch need the CUDA toolkit")
    return path


def library_path() -> Path:
    """Path of the shared library for the current sources (may not exist)."""
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    for name in SOURCES:
        digest.update(name.encode())
        digest.update((_CSRC / name).read_bytes())
    return _BUILD / f"libsos_kernels-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists.

    The compiler's report (``-Xptxas -v``: registers, shared memory,
    spills) is kept beside the library as ``<name>.log``.
    """
    so = library_path()
    if so.exists():
        return so
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *FLAGS, "-o", str(tmp),
           *(str(_CSRC / name) for name in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The bound kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
