"""The matrix-product engine of the LSTM and tail kernels (csrc/gemm.cuh):
its plain twin, its launch count by product, and a wrapper of its test
entry point (csrc/gemm.cu).

Every projection, weight-gradient and dx product of K0, K1, K2, K6f,
K6b-f and K6b-b runs in one GEMM, `gemm_kernel`, launched from inside
those kernels' C entry points. The TPU kernels compute the same products
in their own bodies (lstm_rnn_tpu/ops/lstm_cell.py:227, :449, :475,
:491). (K3b and K4b compute their products in their own kernels; the
engine also runs the wide tail's two products outside its kernels in
bf16 and 3x mode, which ops/softmax_ce.py launches and counts here as
`tail_logits` and `wide_dh`. tail_dh and tail_dW, K3b's products before
its kernels formed their own, run on the 3x TIMIT tail, launched by
`gemm` here.) The products (`USES`):

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

--f32_matmul 3x (`F32_MATMUL_3X`, the JAX package's
lstm_rnn_tpu/ops/lstm_cell.py F32_MATMUL_3X): in float32 mode every
product above, and K4's two products outside its kernels, runs as three
bf16 passes on the tensor cores (csrc/gemm.cuh's gemm3x_kernel): each f32
operand split as a = hi + lo, hi = RN_bf16(a), lo = RN_bf16(a - hi), and
hi.hi + hi.lo + lo.hi summed in f32, as the JAX package's `_kdot(...,
use3=True)` (lstm_cell.py:82-100) forms them. About 2^-16 of a product's
magnitude is lost where true f32 loses 2^-24; exact f32, which the LSTM
recurrence's step product keeps in this mode, lies inside that contract.
The wrappers read the switch when they launch (`use3`), the twins take
it as `x3` and split with `matmul3`; `LAUNCHES[use + ":3x"]` counts the
launches of the 3x instance among those of its use. The mode does nothing
in bfloat16 mode and on the scan route.
"""

from __future__ import annotations

import ctypes
import types
from typing import NamedTuple, Optional, Sequence

import torch

USES = ("proj", "dW_in", "dW_rec", "dx", "tail_dh", "tail_dW")
# the uses outside gemm_run: K4's logits and dh (ops/softmax_ce.py), the
# logits also of the 3x TIMIT tail
WIDE_USES = ("tail_logits", "wide_dh")
# (A transposed, B transposed) per use, as the main path launches them
TRANSPOSE = {"proj": (False, False), "dW_in": (True, False),
             "dW_rec": (True, False), "dx": (False, True),
             "tail_dh": (False, True), "tail_dW": (True, False)}
SPLIT_USES = ("dW_in", "dW_rec", "tail_dW")
# a split's K range starts on a stage boundary of the bf16 body
SPLIT_ALIGN = 64


# Launches of the engine on the main path, one count per use, kept as the
# kernels' wrappers keep theirs (chip_smoke.py resets and reads them);
# "<use>:3x" counts those of them that took the 3x instance
LAUNCHES = {u + sfx: types.SimpleNamespace(launches=0)
            for u in USES + WIDE_USES for sfx in ("", ":3x")}

# --f32_matmul 3x: the process-wide switch the wrappers read at launch (the
# CLI's train mode sets it for its run)
F32_MATMUL_3X = False


def use3(compute_dtype: torch.dtype) -> bool:
    """True when the f32 products take the 3x instance: the switch is
    on and the compute dtype is float32 (the JAX package's `_use3`)."""
    return F32_MATMUL_3X and compute_dtype == torch.float32


def split_bf16(t: torch.Tensor):
    """(hi, lo) of an f32 tensor as f32 tensors holding bf16 values: hi =
    RN_bf16(t), lo = RN_bf16(t - hi) (round to nearest even, as the JAX
    package's astype and the kernels' __float2bfloat16_rn)."""
    hi = t.to(torch.bfloat16)
    lo = (t - hi.float()).to(torch.bfloat16)
    return hi.float(), lo.float()


def matmul3(a: torch.Tensor, b: torch.Tensor, fn=torch.matmul):
    """fn(a, b) as three bf16 passes (`_kdot(..., use3=True)`): fn(ah,
    bh) + fn(ah, bl) + fn(al, bh) of the split f32 operands, each pass an
    f32 product of bf16 values (exact products, f32 sums)."""
    ah, al = split_bf16(a)
    bh, bl = split_bf16(b)
    return fn(ah, bh) + fn(ah, bl) + fn(al, bh)


def product(a: torch.Tensor, b: torch.Tensor, x3: bool, fn=torch.matmul):
    """fn(a, b), split into three bf16 passes when x3."""
    return matmul3(a, b, fn) if x3 else fn(a, b)


def count_launches(*uses: str, x3: bool = False) -> None:
    for u in uses:
        LAUNCHES[u].launches += 1
        if x3:
            LAUNCHES[u + ":3x"].launches += 1


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
                   compute_dtype: torch.dtype = torch.float32,
                   x3: bool = False):
    """The engine's function, plainly: a and b hold one View per pair
    (output d, or group g of dx, takes pair d or g). Returns proj and the
    dW uses as [outputs, M, N] f32, dx as [M, N] f32, tail_dh as [M, N]
    in the operand dtype. x3 (f32): each product as three bf16 passes."""
    _check_args(use, outputs, nsplit, ngroups)
    _check_x3(x3, compute_dtype)
    bf16 = compute_dtype == torch.bfloat16
    if use == "dx":
        total = None
        for g in range(ngroups):
            A, B = _operands(use, a[g], b[g], M, N, K)
            plane = product(A, B, x3)
            if bf16:  # each direction's plane rounded before the sum
                plane = plane.to(torch.bfloat16).float()
            total = plane if total is None else total + plane
        return total
    outs = []
    for d in range(outputs):
        A, B = _operands(use, a[d], b[d], M, N, K)
        acc = None
        for k0, k1 in split_ranges(K, nsplit):
            part = product(A[:, k0:k1], B[k0:k1], x3)
            acc = part if acc is None else acc + part
        if use == "proj":
            acc = acc + bias_mult * bias[d].float()
        outs.append(acc)
    if use == "tail_dh":
        return outs[0].to(compute_dtype)
    return torch.stack(outs)


def _check_x3(x3, compute_dtype):
    if x3 and compute_dtype != torch.float32:
        raise ValueError("the 3x instance takes float32 operands")


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
         compute_dtype: torch.dtype = torch.float32, x3: bool = False):
    """One launch of the engine for `use` on a CUDA tensor (csrc/gemm.cu's
    gemm_run: the instance the main path launches for that product, the 3x
    instance with x3); the twin, gemm_reference, on a CPU tensor. The
    pairs share ld, rows and cols (and b's shift is 0), as on the main
    path; every operand is in compute_dtype. The 3x TIMIT tail launches
    tail_dh and tail_dW here."""
    _check_args(use, outputs, nsplit, ngroups)
    _check_x3(x3, compute_dtype)
    views = list(a) + list(b)
    if views[0].t.device.type == "cpu":
        return gemm_reference(use, a, b, M, N, K, outputs, nsplit, ngroups,
                              bias, bias_mult, compute_dtype, x3)
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
        int(compute_dtype == torch.bfloat16), int(x3), dev.index,
        _stream(out))
    _raise_on(err, f"gemm_run ({use}{' 3x' if x3 else ''}) launch")
    count_launches(use, x3=x3)
    return out


# main_path_case's products: the training fraction's T*B = 25,000 rows
# (bench.py's T = 500, B = 50), H = 125, P = 117 or 250, S = 183 (TIMIT's
# tail, whose dh and dW K3b's own kernels compute in f32 and bf16 mode,
# the engine's in 3x mode); the
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
