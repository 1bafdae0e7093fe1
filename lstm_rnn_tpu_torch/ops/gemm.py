"""The matrix-product engine of the LSTM and tail kernels (csrc/gemm.cuh):
its plain twin, its launch count by product, and a wrapper of its test
entry point (csrc/gemm.cu).

Every projection, weight-gradient and dx product of K0, K1, K2, K6f,
K6b-f and K6b-b runs in one GEMM, `gemm_kernel`, launched from inside
those kernels' C entry points. The TPU kernels compute the same products
in their own bodies (lstm_rnn_tpu/ops/lstm_cell.py:227, :449, :475,
:491). (K3b and K4b compute their products in their own kernels; the
engine also runs the wide tail's two products outside its kernels in
bf16 mode, which ops/softmax_ce.py launches and counts here as
`tail_logits` and `wide_dh`. tail_dh and tail_dW, K3b's products before
its kernels formed their own, run on no path: only `gemm` here launches
them.) The products (`USES`):

- proj:    out[d] = x . W_in[d] + bias_mult * b[d]           (f32)
- dW_in:   out[d] = x^T . da[d]                               (f32)
- dW_rec:  out[d] = h_prev^T . da[d], h shifted by +-B rows   (f32)
- dx:      out = sum_g round(da[g] . W_in[g]^T)               (f32)
- tail_dh: out = dz . W^T                       (the operand dtype)
- tail_dW: out = h^T . dz                                     (f32)

An operand is a `View`: element (r, c) of a row-major matrix at `offset`
in its tensor's storage, with leading dimension `ld`, rows shifted by
`shift`, zero outside [0, rows) x [0, cols). A(m, k) is a(m, k), or
a(k, m) for the uses that transpose A (the dW products); B(k, n) is
b(k, n), or b(n, k) for those that transpose B (dx, tail_dh). The
weight gradients are split over K into `splits(K)` partial products,
each split starting on a 64-row boundary, summed in a fixed order; dx
rounds each direction's plane to the operand dtype (bf16 mode) before
the f32 sum; the projection adds the bias product rounded on its own.

`LAUNCHES[use].launches` counts the engine's launches on the main path;
the wrappers that launch it (lstm_cell's projection and BPTT, softmax_ce's
wide-tail products, and `gemm` here) add to it.
`main_path_case` lays out each product at the shape the main path gives
it.
"""

from __future__ import annotations

import ctypes
import types
from typing import NamedTuple, Optional, Sequence

import torch

USES = ("proj", "dW_in", "dW_rec", "dx", "tail_dh", "tail_dW")
# (A transposed, B transposed) per use, as the main path launches them
TRANSPOSE = {"proj": (False, False), "dW_in": (True, False),
             "dW_rec": (True, False), "dx": (False, True),
             "tail_dh": (False, True), "tail_dW": (True, False)}
SPLIT_USES = ("dW_in", "dW_rec", "tail_dW")
# a split's K range starts on a stage boundary of the bf16 body
SPLIT_ALIGN = 64


# Launches of the engine on the main path, one count per use, kept as the
# kernels' wrappers keep theirs (chip_smoke.py resets and reads them)
LAUNCHES = {u: types.SimpleNamespace(launches=0)
            for u in USES + ("tail_logits", "wide_dh")}


def count_launches(*uses: str) -> None:
    for u in uses:
        LAUNCHES[u].launches += 1


def splits(K: int) -> int:
    """The engine's K splits for a reduction over K rows (gemm.cuh's
    gemm_splits: one per 192 rows, 1 to 32)."""
    return min(32, max(1, K // 192))


def split_ranges(K: int, nsplit: int):
    """[(k_begin, k_end)] of each split, in the order they are summed."""
    per = (K + nsplit - 1) // nsplit
    chunk = (per + SPLIT_ALIGN - 1) // SPLIT_ALIGN * SPLIT_ALIGN
    return [(min(K, s * chunk), min(K, (s + 1) * chunk))
            for s in range(nsplit)]


class View(NamedTuple):
    t: torch.Tensor
    offset: int
    ld: int
    rows: int
    cols: int
    shift: int = 0


def dense(v: View, nrows: int, ncols: int) -> torch.Tensor:
    """v(r, c) for r < nrows, c < ncols as an f32 [nrows, ncols] tensor:
    zero where r + shift is outside [0, rows) or c >= cols."""
    out = torch.zeros((nrows, ncols), dtype=torch.float32,
                      device=v.t.device)
    lo = max(0, -v.shift)
    hi = min(nrows, v.rows - v.shift)
    nc = min(ncols, v.cols)
    if hi > lo and nc > 0:
        out[lo:hi, :nc] = torch.as_strided(
            v.t, (hi - lo, nc), (v.ld, 1), v.t.storage_offset() + v.offset
            + (lo + v.shift) * v.ld).float()
    return out


def _operands(use, a: View, b: View, M: int, N: int, K: int):
    ta, tb = TRANSPOSE[use]
    A = dense(a, K, M).T if ta else dense(a, M, K)
    B = dense(b, N, K).T if tb else dense(b, K, N)
    return A, B


def gemm_reference(use: str, a: Sequence[View], b: Sequence[View], M: int,
                   N: int, K: int, outputs: int = 1, nsplit: int = 1,
                   ngroups: int = 1, bias: Optional[torch.Tensor] = None,
                   bias_mult: float = 1.0,
                   compute_dtype: torch.dtype = torch.float32):
    """The engine's function, plainly: a and b hold one View per pair
    (output d, or group g of dx, takes pair d or g). Returns proj and the
    dW uses as [outputs, M, N] f32, dx as [M, N] f32, tail_dh as [M, N]
    in the operand dtype."""
    _check_args(use, outputs, nsplit, ngroups)
    bf16 = compute_dtype == torch.bfloat16
    if use == "dx":
        total = None
        for g in range(ngroups):
            A, B = _operands(use, a[g], b[g], M, N, K)
            plane = A @ B
            if bf16:  # each direction's plane rounded before the sum
                plane = plane.to(torch.bfloat16).float()
            total = plane if total is None else total + plane
        return total
    outs = []
    for d in range(outputs):
        A, B = _operands(use, a[d], b[d], M, N, K)
        acc = None
        for k0, k1 in split_ranges(K, nsplit):
            part = A[:, k0:k1] @ B[k0:k1]
            acc = part if acc is None else acc + part
        if use == "proj":
            acc = acc + bias_mult * bias[d].float()
        outs.append(acc)
    if use == "tail_dh":
        return outs[0].to(compute_dtype)
    return torch.stack(outs)


def _check_args(use, outputs, nsplit, ngroups):
    if use not in USES:
        raise ValueError(f"use must be one of {USES}, got {use!r}")
    if not 1 <= outputs <= 2 or not 1 <= ngroups <= 2 or nsplit < 1:
        raise ValueError("outputs and ngroups are 1 or 2, nsplit >= 1")
    if (ngroups > 1) != (use == "dx") or (ngroups > 1 and outputs != 1):
        raise ValueError("ngroups > 1 is dx's (one output)")
    if nsplit > 1 and use not in SPLIT_USES:
        raise ValueError(f"only {SPLIT_USES} split K")
    if use in ("dx", "tail_dh") and outputs != 1:
        raise ValueError(f"{use} has one output")


def gemm(use: str, a: Sequence[View], b: Sequence[View], M: int, N: int,
         K: int, outputs: int = 1, nsplit: int = 1, ngroups: int = 1,
         bias: Optional[torch.Tensor] = None, bias_mult: float = 1.0,
         compute_dtype: torch.dtype = torch.float32):
    """One launch of the engine for `use` on a CUDA tensor (csrc/gemm.cu's
    gemm_run: the instance the main path launches for that product); the
    twin, gemm_reference, on a CPU tensor. The pairs share ld, rows and
    cols (and b's shift is 0), as on the main path; every operand is in
    compute_dtype."""
    _check_args(use, outputs, nsplit, ngroups)
    views = list(a) + list(b)
    if views[0].t.device.type == "cpu":
        return gemm_reference(use, a, b, M, N, K, outputs, nsplit, ngroups,
                              bias, bias_mult, compute_dtype)
    from lstm_rnn_tpu_torch.ops import _build
    from lstm_rnn_tpu_torch.ops.lstm_cell import _raise_on, _stream
    dev = views[0].t.device
    npairs = max(outputs, ngroups)
    if len(a) != npairs or len(b) != npairs:
        raise ValueError(f"{npairs} (A, B) pairs expected")
    for name, vs in (("a", a), ("b", b)):
        if any(v.ld != vs[0].ld or v.rows != vs[0].rows
               or v.cols != vs[0].cols for v in vs):
            raise ValueError(f"the pairs' {name} views must share ld, rows "
                             f"and cols")
    if any(v.shift for v in b):
        raise ValueError("b views take no shift")
    for v in views:
        if v.t.device != dev or v.t.dtype != compute_dtype:
            raise TypeError(f"every operand must be {compute_dtype} on {dev}")
        if not v.t.is_contiguous():
            raise ValueError("operands must be contiguous")
    f32 = dict(dtype=torch.float32, device=dev)
    part = None
    if use == "proj":
        if bias is None or bias.dtype != torch.float32 or \
                tuple(bias.shape) != (outputs, N) or bias.device != dev:
            raise ValueError(f"proj needs an f32 bias [{outputs}, {N}] on "
                             f"{dev}")
        bias = bias.contiguous()
        out = torch.empty((outputs, M, N), **f32)
    elif use in SPLIT_USES:
        part = torch.empty((nsplit, outputs, M, N), **f32)
        out = torch.empty((outputs, M, N), **f32)
    elif use == "dx":
        out = torch.empty((M, N), **f32)
    else:
        out = torch.empty((M, N), dtype=compute_dtype, device=dev)

    def ptr(v: View):
        return ctypes.c_void_p(v.t.data_ptr()
                               + v.offset * v.t.element_size())

    err = _build.load().gemm_run(
        USES.index(use), ptr(a[0]), ptr(a[-1]), a[0].ld, a[0].rows,
        a[0].cols, a[0].shift, a[-1].shift, ptr(b[0]), ptr(b[-1]), b[0].ld,
        b[0].rows, b[0].cols, M, N, K, outputs, nsplit, ngroups,
        ctypes.c_void_p(bias.data_ptr()) if bias is not None else None,
        ctypes.c_float(bias_mult),
        ctypes.c_void_p(part.data_ptr()) if part is not None else None,
        ctypes.c_void_p(out.data_ptr()),
        int(compute_dtype == torch.bfloat16), dev.index, _stream(out))
    _raise_on(err, f"gemm_run ({use}) launch")
    count_launches(use)
    return out


# main_path_case's products: the training fraction's T*B = 25,000 rows
# (bench.py's T = 500, B = 50), H = 125, P = 117 or 250, S = 183 (TIMIT's
# tail, whose dh and dW K3b's own kernels compute since PR 11); the
# projection also over 40,000 rows (serving, T = 800),
# 6,250 (an SP or remat block, T = 125) and 4,096 (a streamed 64-frame
# chunk of 64 streams, D = 1, H = 250)
MAIN_PATH_CASES = ("proj:train117", "proj:train250", "proj:serve",
                   "proj:block", "proj:stream", "dW_in:117", "dW_in:250",
                   "dW_rec:asc", "dW_rec:desc", "dx", "tail_dh",
                   "tail_dW:183")


def main_path_case(name: str, dtype: torch.dtype, device,
                   generator: torch.Generator):
    """One of MAIN_PATH_CASES with random N(0, 1) operands (bias too),
    laid out as its caller lays it out: (use, a views, b views, M, N, K,
    keyword arguments of gemm)."""
    def t(*shape):
        return torch.randn(*shape, device=device,
                           generator=generator).to(dtype)
    R, B, H = 25_000, 50, 125
    G = 4 * H
    use, _, arg = name.partition(":")
    if use == "proj":
        R, P = {"train117": (R, 117), "train250": (R, 250),
                "serve": (40_000, 250), "block": (6_250, 250),
                "stream": (4_096, 250)}[arg]
        D, G = (1, 1000) if arg == "stream" else (2, G)
        x, w = t(R, P), t(D, P, G)
        bias = torch.randn(D, G, device=device, generator=generator)
        return ("proj", [View(x, 0, P, R, P)] * D,
                [View(w, d * P * G, G, P, G) for d in range(D)], R, G, P,
                dict(outputs=D, bias=bias))
    if use in ("dW_in", "dW_rec"):
        da = t(2, R, G)
        bv = [View(da, d * R * G, G, R, G) for d in range(2)]
        kw = dict(outputs=2, nsplit=splits(R))
        if use == "dW_in":
            P = int(arg)
            return use, [View(t(R, P), 0, P, R, P)] * 2, bv, P, G, R, kw
        # h_prev of the forward direction is h one step (B rows) earlier,
        # of the backward one step later; "desc" swaps the two
        h = t(R, 2 * H)
        sh = (-B, B) if arg == "asc" else (B, -B)
        return (use, [View(h, d * H, 2 * H, R, H, sh[d]) for d in range(2)],
                bv, H, G, R, kw)
    if use == "dx":
        P = 250
        da, w = t(2, R, G), t(2, P, G)
        return (use, [View(da, d * R * G, G, R, G) for d in range(2)],
                [View(w, d * P * G, G, P, G) for d in range(2)], R, P, G,
                dict(ngroups=2))
    P, S = 250, int(arg or 183)
    dz = t(R, S)
    if use == "tail_dh":
        return (use, [View(dz, 0, S, R, S)], [View(t(P, S), 0, S, P, S)],
                R, P, S, {})
    return (use, [View(t(R, P), 0, P, R, P)], [View(dz, 0, S, R, S)], P, S,
            R, dict(nsplit=splits(R)))
