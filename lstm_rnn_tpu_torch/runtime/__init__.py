"""Native host runtime (ctypes): the JSON formatter.

Counterpart of the JSON half of lstm_rnn_tpu/runtime/__init__.py.
`jsonfmt.cpp` formats large float arrays for io_currennt.dump_doc_json,
byte for byte as Python's json module writes them. The JAX package's
native fraction assembly is not ported: on the H100 the DataSet's NumPy
assembly runs on its prefetch thread, hidden behind the card's steps, and
a native copy of it trained no faster (PERF.md, PR 16).

The library is built with g++ from the source at first use, into
`libjsonfmt_<hash>.so` in the kernel library's build directory
(ops/_build.py `BUILD_DIR`: the package's `_build/`, or the CLI's
--compilation_cache_dir). The hash covers the source and the flags, so an
edited source rebuilds and a library built from another source is never
loaded. Importing this module builds nothing.

`load()` raises RuntimeError with g++'s message when the library cannot be
built or loaded; `available()` is the auto mode's question: it prints that
message once on stderr and answers False, and the caller then takes its
Python path, whose bytes are identical.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
import time
from typing import Optional

import numpy as np

from lstm_rnn_tpu_torch.ops import _build

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("jsonfmt.cpp",)
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")
# the longest repr of a double: -2.2250738585072014e-308
_MAX_REPR = 24

_lock = threading.Lock()
_lib = None
_error: Optional[str] = None
_warned = False
# seconds the last build in this process took (None: loaded a built library)
build_seconds = None


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        with open(os.path.join(_DIR, name), "rb") as f:
            h.update(f.read())
    return os.path.join(_build.BUILD_DIR,
                        f"libjsonfmt_{h.hexdigest()[:16]}.so")


def _compile(out: str) -> None:
    global build_seconds
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    cmd = ["g++", *CXX_FLAGS, "-o", tmp,
           *[os.path.join(_DIR, s) for s in SOURCES]]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, capture_output=True, text=True)
    if p.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"g++ failed ({p.returncode}): {' '.join(cmd)}\n"
                           f"{p.stdout}{p.stderr}")
    build_seconds = time.perf_counter() - t0
    os.replace(tmp, out)


def _declare(lib) -> None:
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    ll = ctypes.c_longlong
    lib.lrt_format_f64_json.argtypes = [f64p, ll, ctypes.c_char_p, ll,
                                        ctypes.c_char_p, ll]
    lib.lrt_format_f64_json.restype = ll


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; raises RuntimeError with
    the compiler's or the loader's message, every call, once it failed."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise RuntimeError(_error)
        try:
            path = library_path()
            if not os.path.exists(path):
                _compile(path)
            lib = ctypes.CDLL(path)
        except (OSError, RuntimeError) as e:
            _error = f"the native runtime is unavailable: {e}"
            raise RuntimeError(_error) from e
        _declare(lib)
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library loads; the first failure is printed once on
    stderr, with the compiler's message."""
    global _warned
    try:
        load()
        return True
    except RuntimeError as e:
        if not _warned:
            _warned = True
            print(f"{e}\n(using the Python path, whose bytes are "
                  "identical)", file=sys.stderr, flush=True)
        return False


def fmt_f64_json(arr: np.ndarray, level: int = 0,
                 indent: int = 1) -> bytes:
    """The bytes json.dumps(..., indent=indent) writes for `arr` as a list
    of float64 values nested `level` deep in the document. Raises
    RuntimeError without the library."""
    lib = load()
    a = np.ascontiguousarray(arr, np.float64).reshape(-1)
    if a.size == 0:
        return b"[]"
    inner = b"\n" + b" " * (indent * (level + 1))
    sep = b"," + inner
    cap = a.size * (_MAX_REPR + len(sep))
    buf = ctypes.create_string_buffer(cap)
    n = lib.lrt_format_f64_json(a, a.size, sep, len(sep), buf, cap)
    if n < 0:
        raise RuntimeError("lrt_format_f64_json: buffer too small")
    return (b"[" + inner + buf.raw[:n] + b"\n" + b" " * (indent * level)
            + b"]")
