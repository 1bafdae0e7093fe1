"""Native host runtime (ctypes): the fraction assembly and the JSON
formatter.

Counterpart of lstm_rnn_tpu/runtime/__init__.py. `fraction.cpp` assembles
a DataSet's fraction (padding, frame splicing, output_time_lag, patTypes)
byte for byte as the DataSet's NumPy path does, into new arrays or into
arrays the caller owns (the Trainer's pinned staging buffer); the DataSet
takes it when there is no input noise (data/dataset.py `use_native`).
`jsonfmt.cpp` formats large float arrays for io_currennt.dump_doc_json,
byte for byte as Python's json module writes them.

The library is built with g++ from both sources at first use, into
`libruntime_<hash>.so` in the kernel library's build directory
(ops/_build.py `BUILD_DIR`: the package's `_build/`, or the CLI's
--compilation_cache_dir). The hash covers the sources and the flags, so
an edited source rebuilds and a library built from another source is
never loaded. Importing this module builds nothing.

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
SOURCES = ("fraction.cpp", "jsonfmt.cpp")
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
                        f"libruntime_{h.hexdigest()[:16]}.so")


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
    c = ctypes.c_int
    vp = ctypes.c_void_p
    lib.lrt_assemble_fraction.argtypes = [vp, vp, vp, vp, c, c, c, c, c, c,
                                          c, c, c, vp, vp, vp]
    lib.lrt_assemble_fraction.restype = None
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


def _out_array(a, dtype, shape, name: str) -> np.ndarray:
    """a, checked to be a writeable C-contiguous array of dtype and shape
    (an out= array is written in place, never through a copy)."""
    if (not isinstance(a, np.ndarray) or a.dtype != dtype
            or a.shape != shape or not a.flags.c_contiguous
            or not a.flags.writeable):
        got = (f"{a.dtype} {a.shape}, C-contiguous {a.flags.c_contiguous}, "
               f"writeable {a.flags.writeable}"
               if isinstance(a, np.ndarray) else type(a).__name__)
        raise ValueError(f"assemble_fraction: out {name} must be a writeable "
                         f"C-contiguous {np.dtype(dtype)} array of shape "
                         f"{shape}; got {got}")
    return a


def assemble_fraction(inputs_cat: np.ndarray, targets_cat: np.ndarray,
                      offsets: np.ndarray, lengths: np.ndarray,
                      is_classification: bool, t_pad: int, b: int,
                      f_size: int, o_size: int, left: int, right: int,
                      lag: int, out=None):
    """A fraction's (inputs [t_pad, b, ctx * f_size] float32, targets
    [t_pad, b] int32 or [t_pad, b, o_size] float32, pattypes [t_pad, b]
    int8), as the DataSet's NumPy path assembles it without input noise,
    from at most b sequences: sequence i is rows offsets[i] ..
    offsets[i] + lengths[i] of inputs_cat [frames, f_size] and
    targets_cat [frames] int32 or [frames, o_size] float32 (the sequences
    concatenated, or a whole file's frames). out=(inputs, targets,
    pattypes): the caller's C-contiguous arrays of those dtypes and
    shapes, every byte of which is written (ValueError on any other);
    else new arrays. Raises RuntimeError without the library. The call
    releases the GIL."""
    lib = load()
    ctx = left + right + 1
    t_dtype = np.int32 if is_classification else np.float32
    shapes = ((t_pad, b, ctx * f_size),
              (t_pad, b) if is_classification else (t_pad, b, o_size),
              (t_pad, b))
    dtypes = (np.float32, t_dtype, np.int8)
    if out is None:
        out = tuple(np.empty(s, d) for s, d in zip(shapes, dtypes))
    else:
        out = tuple(_out_array(a, d, s, name) for a, d, s, name in zip(
            out, dtypes, shapes, ("inputs", "targets", "pattypes")))
    inputs_cat = np.ascontiguousarray(inputs_cat, np.float32)
    targets_cat = np.ascontiguousarray(targets_cat, t_dtype)
    lengths = np.asarray(lengths, np.int64)
    offsets = np.asarray(offsets, np.int64)
    n, frames = len(lengths), len(inputs_cat)
    # the C side indexes frames with int offsets
    if (frames >= 2**31 or n > b or offsets.shape != lengths.shape
            or inputs_cat.shape != (frames, f_size)
            or targets_cat.shape != ((frames,) if is_classification
                                     else (frames, o_size))
            or (n and (lengths.min() < 0 or lengths.max() > t_pad
                       or offsets.min() < 0
                       or (offsets + lengths).max() > frames))):
        raise ValueError("assemble_fraction: the sequences do not fit the "
                         f"fraction ({n} sequences of {lengths.tolist()} "
                         f"frames at {offsets.tolist()} of "
                         f"{inputs_cat.shape} / {targets_cat.shape}; t_pad "
                         f"{t_pad}, b {b})")
    offsets = offsets.astype(np.int32)
    lengths = lengths.astype(np.int32)
    # the NumPy path shifts nothing for a lag below 0
    lib.lrt_assemble_fraction(
        inputs_cat.ctypes.data, targets_cat.ctypes.data, offsets.ctypes.data,
        lengths.ctypes.data, n, int(is_classification), t_pad, b, f_size,
        o_size, left, right, max(lag, 0), *(a.ctypes.data for a in out))
    return out
