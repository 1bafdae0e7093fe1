"""Build the CUDA kernels (csrc/*.cu) with nvcc and bind them with ctypes.

Each source compiles in its own nvcc process, all started together, and
the objects link into one shared library with a plain C interface,
`_build/liblstm_kernels_<hash>.so` inside the package (or in the directory
`use_dir` names: the CLI's --compilation_cache_dir); the hash covers the
sources and the flags, so an edited source rebuilds and an unchanged one
loads the library already built. Only the repository's sources and the
installed CUDA toolkit are used. Importing this module builds nothing: the
first kernel launch calls `load()`. The package imports on a machine with
no nvcc; only a launch needs it.

Usage: `load()` returns the ctypes library; `python -m
lstm_rnn_tpu_torch.ops._build` builds and prints the compiler's report
(registers, shared memory and spills per kernel) and the HGMMA count of
each instance of the GEMM engine (its 3x instances among them), of K3f,
of K4b and of K3b.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
# seconds the last build in this process took (None: loaded a built library)
build_seconds = None


def use_dir(path: str) -> None:
    """Build into and load from `path` (created at the first build) in
    place of the package's _build/, for this process: the CLI's
    --compilation_cache_dir. The native runtime (runtime/) builds there
    too. A library this process already loaded stays loaded."""
    global BUILD_DIR
    BUILD_DIR = os.path.abspath(path)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found: the CUDA kernels build at first launch on a machine "
        "with the CUDA toolkit (put nvcc on PATH or set CUDA_HOME)")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"liblstm_kernels_{h.hexdigest()[:16]}.so")


def build_log() -> str:
    """The compiler's report of the library `load()` uses ('' if none)."""
    path = library_path() + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def _cuda_tool(name: str) -> str:
    return os.path.join(os.path.dirname(_nvcc()), name)


@functools.lru_cache(maxsize=None)
def _sass(path: str) -> str:
    """cuobjdump -sass of a built library (tens of seconds; a library's
    path names its sources' hash, so one dump serves every query)."""
    return subprocess.run([_cuda_tool("cuobjdump"), "-sass", path],
                          capture_output=True, text=True, check=True).stdout


def sass_counts(opcode: str, name_part: str = "gemm_kernel"):
    """{kernel: count} of the SASS instructions whose opcode starts with
    `opcode` (e.g. HGMMA, the tensor cores' warpgroup product) in each
    kernel of the built library whose mangled name contains
    `name_part`, read with cuobjdump -sass."""
    counts, name = {}, None
    for line in _sass(library_path()).splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            if name_part in name:
                counts[name] = 0
            else:
                name = None
        elif name is not None and "*/" in line:
            tok = line.split("*/", 1)[1].split()
            if tok and tok[0].startswith("@"):  # a predicate
                tok = tok[1:]
            if tok and tok[0].startswith(opcode):
                counts[name] += 1
    return counts


def _run_all(cmds):
    """Run the commands in parallel; raise on the first that failed.
    Returns their combined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, o in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(cmd)}\n{o}")
    return "".join(outs)


def _compile(out: str) -> None:
    global build_seconds
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    cus = [p for p in _sources() if p.endswith(".cu")]
    objs = [f"{tmp}.{os.path.basename(p)}.o" for p in cus]
    t0 = time.perf_counter()
    log = _run_all([[_nvcc(), *NVCC_FLAGS, "-c", "-o", o, p]
                    for p, o in zip(cus, objs)])
    log += _run_all([[_nvcc(), "-shared", "-o", tmp, *objs]])
    build_seconds = time.perf_counter() - t0
    for o in objs:
        os.remove(o)
    with open(out + ".log", "w") as f:
        f.write(log)
    os.replace(tmp, out)


def _declare(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lstm_fwd_proj.argtypes = [p, p, p, p, i, i, i, i, ctypes.c_float, i,
                                  i, i, p]
    lib.lstm_fwd_proj.restype = i
    ll = ctypes.c_longlong
    lib.gemm_run.argtypes = [i, p, p, ll, i, i, i, i, p, p, ll, i, i] \
        + [i] * 6 + [p, ctypes.c_float, p, p, i, i, i, p]
    lib.gemm_run.restype = i
    lib.lstm_fwd_rec.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.lstm_fwd_rec.restype = i
    lib.lstm_fwd_rec_carry.argtypes = [p] * 10 + [i] * 8 + [p]
    lib.lstm_fwd_rec_carry.restype = i
    lib.lstm_fwd_rec_carry_save.argtypes = [p] * 11 + [i] * 8 + [p]
    lib.lstm_fwd_rec_carry_save.restype = i
    lib.lstm_bwd.argtypes = [p] * 15 + [i] * 5 + [ctypes.c_float] + [i] * 5 \
        + [p]
    lib.lstm_bwd.restype = i
    lib.lstm_bwd_carry.argtypes = [p] * 21 + [i] * 7 + [ctypes.c_float] \
        + [i] * 5 + [p]
    lib.lstm_bwd_carry.restype = i
    lib.softmax_ce_fwd.argtypes = [p] * 9 + [i] * 3 + [ctypes.c_float, i, i,
                                                       p]
    lib.softmax_ce_fwd.restype = i
    lib.softmax_ce_bwd.argtypes = [p] * 11 + [i] * 4 + [ctypes.c_float, i, i,
                                                        p]
    lib.softmax_ce_bwd.restype = i
    lib.softmax_ce_wide_fwd.argtypes = [p] * 9 + [i] * 4 + [p]
    lib.softmax_ce_wide_fwd.restype = i
    lib.softmax_ce_wide_bwd.argtypes = [p] * 14 + [i] * 4 + [
        ctypes.c_float, i, i, i, p]
    lib.softmax_ce_wide_bwd.restype = i
    lib.softmax_ce_wide_logits.argtypes = [p] * 4 + [i] * 3 + [
        ctypes.c_float, i, i, p]
    lib.softmax_ce_wide_logits.restype = i
    lib.softmax_ce_wide_dh.argtypes = [p] * 3 + [i] * 6 + [p]
    lib.softmax_ce_wide_dh.restype = i
    lib.softmax_ce_plain_fwd.argtypes = [p] * 7 + [i] * 4 + [p]
    lib.softmax_ce_plain_fwd.restype = i
    lib.softmax_ce_plain_bwd.argtypes = [p] * 4 + [i] * 4 + [p]
    lib.softmax_ce_plain_bwd.restype = i
    for name in ("lstm_fwd_rec_plan", "lstm_bwd_plan"):
        getattr(lib, name).argtypes = [i, i, i, p]
        getattr(lib, name).restype = i
    lib.lstm_tp_peer.argtypes = [i, i]
    lib.lstm_tp_peer.restype = i
    lib.lstm_tp_host_alloc.argtypes = [ctypes.c_size_t]
    lib.lstm_tp_host_alloc.restype = p
    d = ctypes.c_double
    lib.lstm_tp_fwd.argtypes = [i] + [p] * 11 + [i] * 4 + [d] + [i] * 8 \
        + [p]
    lib.lstm_tp_fwd.restype = i
    lib.lstm_tp_bwd.argtypes = [i] + [p] * 13 + [i] * 4 + [d] + [i] * 8 \
        + [p]
    lib.lstm_tp_bwd.restype = i
    lib.lstm_act_probe.argtypes = [p, p, i, i, p]
    lib.lstm_act_probe.restype = i
    lib.lstm_bwd_splits.argtypes = [i]
    lib.lstm_bwd_splits.restype = i
    lib.lstm_err_str.argtypes = [i]
    lib.lstm_err_str.restype = ctypes.c_char_p


def load():
    """Build (if needed) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _compile(path)
            lib = ctypes.CDLL(path)
            _declare(lib)
            _lib = lib
        return _lib


if __name__ == "__main__":
    load()
    print(build_log())
    for part in ("gemm_kernel", "gemm3x_kernel", "ce_fwd_kernel",
                 "wide_bwd_", "pb_dh_kernel", "pb_dw_kernel"):
        for kernel, n in sorted(sass_counts("HGMMA", part).items()):
            print(f"{n:5d} HGMMA  {kernel}")
