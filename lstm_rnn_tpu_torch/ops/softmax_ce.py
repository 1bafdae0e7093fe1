"""The fused classification tail on the GPU: identity feedforward ->
CURRENNT softmax -> multiclass cross-entropy -> accuracy count.

Counterpart of lstm_rnn_tpu/ops/softmax_ce.py. Three tails, each a pair of
kernels behind wrappers with a launch count; Network.loss_and_count_fused
picks one (K5 under remat, else K3 where `proj_tail_fits`, else K4 where
`wide_tail_fits`, else K5).

The projection tail (`softmax_ce_proj_fused`, whose custom VJP in the JAX
package launches `_fwd_proj_kernel` and `_bwd_proj_kernel`; K3), in
csrc/softmax_ce.cu, for nets whose forward fits a block's shared memory
(`proj_tail_fits`: S <= 704 on the H100):

- `softmax_ce_proj_fwd`: logits = h . W + bias_mult * b in the kernel's
  own product (wgmma in bf16, register-blocked SIMT in f32), the CURRENNT
  softmax (offset (min + max) / 2 with the
  max floored at REAL_MIN, safeExp), loss = sum of -log max(p[target],
  REAL_MIN) and the first-argmax == target count over rows with
  target >= 0, and p [N, S] when the caller trains (want_p);
- `softmax_ce_proj_bwd`: dz = g p (onehot (-1/p_c) - s), masked, from the
  stored p; dh = dz . W^T, dW = h^T . dz, db = bias_mult * sum dz, in four
  launches that form dz on the chip and never store it (`proj_bwd_plan`
  lays them out).

`softmax_ce_proj_fused` with gradients goes through SoftmaxCeProjFused
(forward with want_p, backward kernel); without, it runs the forward with
want_p off. Widths are exact: W [P, S], b [S]; the JAX package's 128-lane
padding of S and P is a TPU tiling rule the kernels do not need.

The wide tail (`softmax_ce_wide_fused`: `_fwd_wide_kernel` and
`_bwd_wide_kernel`; K4), in csrc/softmax_ce_wide.cu, for LVCSR-scale
softmaxes (~10k states). The logits a = h . W + bias_mult * b are one
product outside the kernels, as in the JAX package (`wide_logits`):

- `softmax_ce_wide_fwd`: from a, the loss, the count and three per-row
  stats (offset, exp sum, target probability) when the caller trains
  (want_stats); the [N, S] probabilities are never stored;
- `softmax_ce_wide_bwd`: one fused kernel: p recomputed from a and the
  stats, dz stored once, dW = h^T . dz accumulated per column block on
  the chip (wgmma in bf16, register-blocked SIMT in f32) and db =
  bias_mult * sum dz (`wide_bwd_plan` lays out its launch); dh = dz . W^T
  is one product outside.

The plain tail (`softmax_ce_fused`: `_fwd_kernel` and `_bwd_kernel`; K5),
in csrc/softmax_ce_plain.cu, the tail of --remat_blocks training
(Network.loss_and_count_fused), from logits a [N, S] f32 materialized by
the softmax layer's product outside, under autograd:

- `softmax_ce_fwd`: the loss, the count, and p [N, S] in the storage dtype
  when the caller trains (want_p); the count from the f32 p; one read of
  each row into registers, a warp or the block a row (`plain_fwd_plan`
  mirrors the launch);
- `softmax_ce_bwd`: dz = g p (onehot (-1/p_c) - s), masked, from the
  stored p, in f32 (a's dtype).

The twins share the JAX package's bodies (`_row_probs`, `_tail_fwd_body`
as `_loss_count`, `_tail_dz`) across the three tails.

Precision: float32 mode is true f32. bfloat16 mode rounds h and W to bf16
(f32 accumulation), stores p (K3) or the logits (K4) in bf16, rounds dz to
bf16 before the products (db sums the unrounded dz), as the JAX kernels
do; K3 returns dh in bf16, K4 in h's dtype. The two products outside K4
(the logits, dh) run in bf16 mode on the card in csrc/gemm.cuh's engine
on the tensor cores, bf16 operands with f32 sums, as the JAX package's
bf16 dots with f32 accumulation; in float32 mode in cuBLAS, true f32,
refusing to run with TF32 on; their twins in f32 on the storage dtype's
values (a product of two bf16 values is exact in f32). On a CUDA tensor
each wrapper launches its kernel or raises; on a CPU tensor it runs its
plain twin.

--f32_matmul 3x (float32 mode, ops/gemm.py `F32_MATMUL_3X`; the JAX
kernels' `_kdot(..., use3)`): K4's logits and dh run in the engine's 3x
instance, and K4b's dW in its own 3x instance (`wide_bwd_3x_kernel`: h and
dz split into bf16 hi and lo, three wgmma a step), where f32 mode runs
cuBLAS and the SIMT body. A K3 tail takes the plain route instead
(`softmax_ce_3x_fused`): the engine's 3x logits, K5f and K5b, then the
engine's 3x tail_dh and tail_dW, K3's function with its products in 3x;
K3f and K3b have no 3x body. The remat route's K5 tail keeps its f32
product, as in the JAX package. The twins take the mode as `x3` and split
the same products (ops/gemm.py `matmul3`).
"""

from __future__ import annotations

import ctypes
import functools
import types

import torch

from lstm_rnn_tpu_torch.ops.activations import REAL_MIN, safe_exp
from lstm_rnn_tpu_torch.ops.gemm import (View, count_launches, gemm,
                                         product, splits, use3)
from lstm_rnn_tpu_torch.ops.lstm_cell import (_check_compute_dtype, _on_cuda,
                                              _ptr, _raise_on, _stream,
                                              storage_dtype)


def _row_probs(a):
    """The CURRENNT softmax of f32 logits [N, S] (the JAX package's
    `_row_probs`): the offset (min + max) / 2 with the max floored at
    REAL_MIN, safeExp, p = e / sum e. Returns (p, off [N, 1], ssum
    [N, 1])."""
    mn = a.amin(dim=-1, keepdim=True)
    mx = torch.clamp_min(a.amax(dim=-1, keepdim=True), REAL_MIN)
    off = 0.5 * (mn + mx)
    e = safe_exp(a - off)
    ssum = e.sum(dim=-1, keepdim=True)
    return e / ssum, off, ssum


def _loss_count(p, targets):
    """(loss, count, pt) of the f32 p [N, S] (the JAX package's
    `_tail_fwd_body`): pt = p[target] (0 on a dummy row), loss = sum of
    -log max(pt, REAL_MIN) and the count of first-argmax == target, both
    over rows with target >= 0."""
    tc = targets.long()
    valid = tc >= 0
    pt = torch.where(valid, p.gather(1, tc.clamp_min(0)[:, None])[:, 0],
                     torch.zeros_like(p[:, 0]))
    loss = -(torch.log(torch.clamp_min(pt, REAL_MIN)) * valid).sum()
    # the first argmax of p, not of e: two different e can round to the
    # same p (torch.argmax returns the first maximal index)
    cnt = ((p.argmax(dim=-1) == tc) & valid).sum().to(torch.int32)
    return loss, cnt, pt


def _tail_dz(p, targets, pt, g):
    """dz [N, S] f32 (the JAX package's `_tail_dz`): g p (onehot inv -
    pt inv), masked to rows with target >= 0, inv = -1/max(pt,
    REAL_MIN); p [N, S] and pt [N] f32, g the loss cotangent."""
    tc = targets.long()
    valid = (tc >= 0).float()[:, None]
    onehot = torch.zeros_like(p).scatter_(
        1, tc.clamp_min(0)[:, None], 1.0) * valid
    inv = -1.0 / torch.clamp_min(pt, REAL_MIN)[:, None]
    return p * (onehot * inv - pt[:, None] * inv) * valid * g.float()


def plain_dz_reference(p, targets, g):
    """dz [N, S] f32 from a stored p [N, S] (storage dtype) and the loss
    cotangent g: K5b's plain twin, and the dz of K3b's; pt is read from
    the stored p."""
    pf = p.float()
    tc = targets.long()
    pt = torch.where(tc >= 0, pf.gather(1, tc.clamp_min(0)[:, None])[:, 0],
                     torch.zeros_like(pf[:, 0]))
    return _tail_dz(pf, targets, pt, g)


def softmax_ce_fwd_reference(h2, W, b, targets, bias_mult: float,
                             compute_dtype: torch.dtype = torch.float32,
                             want_p: bool = True):
    """The forward kernel's plain-torch twin. h2 [N, P], W [P, S], b [S],
    targets [N] int (-1 = dummy). Returns (loss f32 scalar, count int32
    scalar, p [N, S] in the storage dtype or None)."""
    sdtype = storage_dtype(compute_dtype)
    a = torch.matmul(h2.to(sdtype).float(), W.to(sdtype).float())
    a = a + bias_mult * b.float()
    p, _, _ = _row_probs(a)
    loss, cnt, _ = _loss_count(p, targets)
    return loss, cnt, (p.to(sdtype) if want_p else None)


def softmax_ce_bwd_reference(p, h2, W, targets, g, bias_mult: float,
                             compute_dtype: torch.dtype = torch.float32):
    """The backward kernel's plain-torch twin, from the stored p (storage
    dtype) and the loss cotangent g (a scalar tensor). Returns (dh [N, P]
    in the storage dtype, dW [P, S] f32, db [S] f32)."""
    sdtype = storage_dtype(compute_dtype)
    dz = plain_dz_reference(p, targets, g)
    dzc = dz.to(sdtype).float()
    dh = torch.matmul(dzc, W.to(sdtype).float().t()).to(sdtype)
    dw = torch.matmul(h2.to(sdtype).float().t(), dzc)
    return dh, dw, bias_mult * dz.sum(dim=0)


# K3's forward footprint in shared memory (csrc/softmax_ce.cu: kCeRows,
# kCeChunk, kCeMaxChunks, kCeWideChunks, kCeTile, kCeStaticBytes,
# ce_ring_bytes, ce_smem_bytes; gemm.cuh: kSimtBK, kSimtPad; a CPU test
# reads them from the sources): 64 rows a block; S <= 256 in one pass of
# 64-column chunks, the logits in registers (bf16) or in a [64, S] f32
# block over the stage ring (f32); above, passes of 128 columns into that
# block beside the ring. (The persistent bf16 body with W resident, taken
# at S <= 256 where it fits on its own, does not bound the route.)
_PROJ_ROWS = 64
_PROJ_CHUNK = 64
_PROJ_MAX_CHUNKS = 4
_PROJ_WIDE_CHUNKS = 2
_PROJ_TILE = 64 * 64 * 2  # a bf16 stage's A tile, or one chunk of B
_PROJ_STATIC = 6 * _PROJ_ROWS * 4  # a loss and a hit per row, 3 warpgroups
_SIMT_BK, _SIMT_PAD = 16, 4
# an H100's shared memory per block (opt-in): the budget on the CPU, so
# that the twins take the route the card takes
H100_SMEM_OPTIN = 232_448
# an H100's SMs: the CPU plans the launches the card makes
H100_SMS = 132


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _proj_ring_bytes(bf16: bool, nch: int) -> int:
    if bf16:  # two stages, plus 1 KB to align the 128-byte swizzle
        return 2 * (1 + nch) * _PROJ_TILE + 1024
    return 2 * _SIMT_BK * (_PROJ_ROWS + _SIMT_PAD + nch * _PROJ_CHUNK
                           + _SIMT_PAD) * 4


def proj_smem_bytes(S: int, bf16: bool) -> int:
    """Shared memory a block of K3's forward takes at S classes (dynamic
    and static), in bf16 or f32 mode."""
    logits = _PROJ_ROWS * (-(-S // 8) * 8) * 4
    if S > _PROJ_MAX_CHUNKS * _PROJ_CHUNK:
        dyn = _proj_ring_bytes(bf16, _PROJ_WIDE_CHUNKS) + logits
    else:
        ring = _proj_ring_bytes(bf16, -(-S // _PROJ_CHUNK))
        dyn = ring if bf16 else max(ring, logits)
    return dyn + _PROJ_STATIC


def proj_tail_fits(S: int, smem_optin: int) -> bool:
    """True when K3's forward fits S classes in `smem_optin` bytes of
    shared memory per block in both modes (S <= 704 on the H100); wider
    nets take K4."""
    return max(proj_smem_bytes(S, True),
               proj_smem_bytes(S, False)) <= smem_optin


def tail_smem_optin(device) -> int:
    """The shared memory per block the tail may use on `device`: the
    card's opt-in limit, or the H100's on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_properties(
            device).shared_memory_per_block_optin
    return H100_SMEM_OPTIN


def _check(h2, W, b, targets):
    if h2.dim() != 2 or W.dim() != 2 or W.shape[0] != h2.shape[1]:
        raise ValueError(f"h2 must be [N, P] and W [P, S]; got "
                         f"{tuple(h2.shape)} and {tuple(W.shape)}")
    if tuple(b.shape) != (W.shape[1],) or \
            tuple(targets.shape) != (h2.shape[0],):
        raise ValueError(f"b must be [S] and targets [N]; got "
                         f"{tuple(b.shape)} and {tuple(targets.shape)}")


def softmax_ce_proj_fwd(h2, W, b, targets, bias_mult: float = 1.0,
                        compute_dtype: torch.dtype = torch.float32,
                        want_p: bool = True):
    """(loss, count, p or None): the CUDA kernel on a CUDA tensor, the twin
    on a CPU one."""
    _check_compute_dtype(compute_dtype)
    _check(h2, W, b, targets)
    if not _on_cuda(h2, "softmax_ce_proj_fwd"):
        return softmax_ce_fwd_reference(h2, W, b, targets, bias_mult,
                                        compute_dtype, want_p)
    N, P = h2.shape
    S = W.shape[1]
    have = tail_smem_optin(h2.device)
    if not proj_tail_fits(S, have):
        raise ValueError(
            f"softmax_ce_proj_fwd: {S} classes do not fit the card's "
            f"{have} bytes of shared memory per block; "
            f"softmax_ce_wide_fused serves such nets")
    from lstm_rnn_tpu_torch.ops import _build
    lib = _build.load()
    sdtype = storage_dtype(compute_dtype)
    dev = h2.device
    hc = h2.to(sdtype).contiguous()
    wc = W.to(sdtype).contiguous()
    bc = b.float().contiguous()
    tc = targets.to(device=dev, dtype=torch.int32).contiguous()
    nblk = (N + 63) // 64
    p = torch.empty((N, S), dtype=sdtype, device=dev) if want_p else None
    part_loss = torch.empty(nblk, dtype=torch.float32, device=dev)
    part_cnt = torch.empty(nblk, dtype=torch.int32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    cnt = torch.empty((), dtype=torch.int32, device=dev)
    err = lib.softmax_ce_fwd(
        _ptr(hc), _ptr(wc), _ptr(bc), _ptr(tc), _ptr(p) if want_p else None,
        _ptr(part_loss), _ptr(part_cnt), _ptr(loss), _ptr(cnt), N, P, S,
        ctypes.c_float(bias_mult), int(sdtype == torch.bfloat16), dev.index,
        _stream(h2))
    _raise_on(err, "softmax_ce_fwd launch")
    softmax_ce_proj_fwd.launches += 1
    return loss, cnt, p


# Kernel launches on the main path (chip_smoke.py resets and reads them).
softmax_ce_proj_fwd.launches = 0


# K3b's tiles (csrc/softmax_ce.cu: kPbRows, kPbDhCols, kPbDhKBf16,
# kPbDhKF32, kPbResColsBf16, kPbResColsF32, kPbResMax, kPbDwRows,
# kPbDwCols, kPbDwTileBf16, kPbDwTileF32; a CPU test reads them): W packed
# zero-padded to [pp, sp] (sp: S rounded up to 64 in bf16, 32 in f32); dh
# in tiles of 64 rows, by persistent blocks that hold 256 (bf16) or 128
# (f32) columns of W resident where S <= 192, else by blocks of 256
# columns over chunks of S; dW in blocks of
# 128 rows (of P: a pass) x 192 columns (of S) over a split of the row
# tiles of 64 (bf16) or 32 (f32) rows
_PB_ROWS, _PB_DH_COLS = 64, 256
_PB_DH_K = {True: 64, False: 32}
_PB_RES_COLS = {True: 256, False: 128}
_PB_RES_MAX = 192
_PB_DW_ROWS, _PB_DW_COLS = 128, 192
_PB_DW_TILE = {True: 64, False: 32}


def proj_bwd_plan(N: int, P: int, S: int, bf16: bool,
                  sms: int = H100_SMS) -> dict:
    """K3b's launch at N rows, P and S: W's packed shape (pp, sp), dh's
    body (resident or streamed) and grid, and the dW kernel's column
    blocks, passes over P, row tiles and row splits (one block an SM: as
    many splits as fill `sms` SMs once, none without rows); its partials
    are [nsplit, P S + S] f32."""
    rows = _PB_DW_TILE[bf16]
    ntiles = -(-N // rows)
    cols, passes = -(-S // _PB_DW_COLS), -(-P // _PB_DW_ROWS)
    want = max(1, min(ntiles, round(sms / (cols * passes))))
    tps = -(-ntiles // want)
    k = _PB_DH_K[bf16]
    dh_tiles = -(-N // _PB_ROWS)
    resident = S <= _PB_RES_MAX
    if resident:
        pcs = -(-P // _PB_RES_COLS[bf16])
        dh_grid = (max(1, min(dh_tiles, sms // pcs)), pcs)
    else:
        dh_grid = (dh_tiles, -(-P // _PB_DH_COLS))
    return dict(pp=-(-P // _PB_DH_COLS) * _PB_DH_COLS, sp=-(-S // k) * k,
                dh_resident=resident, dh_grid=dh_grid, cols=cols,
                passes=passes, rows=rows, ntiles=ntiles, tps=tps,
                nsplit=-(-ntiles // tps))


def _launch_proj_bwd(p, hc, wc, targets, g, bias_mult: float,
                     dz_out=None):
    """K3b's four launches on the card (p, hc [N, P] and wc [P, S] in the
    storage dtype): (dh [N, P] storage dtype, dW [P, S] f32, db [S] f32).
    dz_out, an [N, S] f32 tensor or None, receives dz before its rounding
    (a test's view of what never leaves the chip)."""
    from lstm_rnn_tpu_torch.ops import _build
    lib = _build.load()
    N, S = p.shape
    P = hc.shape[1]
    dev = p.device
    bf16 = p.dtype == torch.bfloat16
    plan = proj_bwd_plan(N, P, S, bf16, _sm_count(dev.index))
    # p's rows are copied in aligned 16-byte chunks, h's in 4-byte words
    pc = p.contiguous() if p.data_ptr() % 16 == 0 else p.clone()
    hc = hc.contiguous() if hc.data_ptr() % 4 == 0 else hc.clone()
    tc = targets.to(device=dev, dtype=torch.int32).contiguous()
    gc = g.to(device=dev, dtype=torch.float32).reshape(1).contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    rowc = torch.empty((N, 4), **f32)
    wp = torch.empty(plan["pp"] * plan["sp"], dtype=p.dtype, device=dev)
    part = torch.empty((plan["nsplit"], P * S + S), **f32)
    dh = torch.empty((N, P), dtype=p.dtype, device=dev)
    out = torch.empty(P * S + S, **f32)
    if dz_out is not None and (dz_out.dtype != torch.float32
                               or tuple(dz_out.shape) != (N, S)
                               or not dz_out.is_contiguous()):
        raise ValueError("dz_out must be a contiguous [N, S] float32 tensor")
    err = lib.softmax_ce_bwd(
        _ptr(pc), _ptr(hc), _ptr(wc.contiguous()), _ptr(tc), _ptr(gc),
        _ptr(rowc), _ptr(wp), _ptr(part), _ptr(dh), _ptr(out),
        _ptr(dz_out) if dz_out is not None else None, N, P, S,
        plan["nsplit"], ctypes.c_float(bias_mult), int(bf16), dev.index,
        _stream(p))
    _raise_on(err, "softmax_ce_bwd launch")
    return dh, out[:P * S].view(P, S), out[P * S:]


def softmax_ce_proj_bwd(p, h2, W, targets, g, bias_mult: float = 1.0,
                        compute_dtype: torch.dtype = torch.float32):
    """(dh, dW, db): the CUDA kernels on a CUDA tensor, the twin on a CPU
    one. p is the forward's stored p, g the loss cotangent (a scalar
    tensor on the same device: it is read by the kernel, no host sync)."""
    _check_compute_dtype(compute_dtype)
    _check(h2, W, W.new_empty(W.shape[1]), targets)
    if not _on_cuda(h2, "softmax_ce_proj_bwd"):
        return softmax_ce_bwd_reference(p, h2, W, targets, g, bias_mult,
                                        compute_dtype)
    sdtype = storage_dtype(compute_dtype)
    if p.dtype != sdtype or tuple(p.shape) != (h2.shape[0], W.shape[1]):
        raise ValueError(f"p must be [N, S] in {sdtype}")
    out = _launch_proj_bwd(p, h2.to(sdtype), W.to(sdtype), targets, g,
                           bias_mult)
    softmax_ce_proj_bwd.launches += 1
    return out


softmax_ce_proj_bwd.launches = 0


class SoftmaxCeProjFused(torch.autograd.Function):
    """softmax_ce_proj_fused with gradients to h2, W and b."""

    @staticmethod
    def forward(ctx, h2, W, b, targets, bias_mult, compute_dtype):
        loss, cnt, p = softmax_ce_proj_fwd(h2, W, b, targets, bias_mult,
                                           compute_dtype, want_p=True)
        ctx.save_for_backward(p, h2, W, targets)
        ctx.cfg = (bias_mult, compute_dtype)
        ctx.mark_non_differentiable(cnt)
        return loss, cnt

    @staticmethod
    def backward(ctx, g_loss, _g_cnt):
        p, h2, W, targets = ctx.saved_tensors
        dh, dw, db = softmax_ce_proj_bwd(p, h2, W, targets, g_loss,
                                         *ctx.cfg)
        return dh.to(h2.dtype), dw.to(W.dtype), db, None, None, None


def softmax_ce_proj_fused(h2, W, b, targets, S: int, bias_mult: float,
                          compute_dtype: torch.dtype = torch.float32):
    """Fused (identity feedforward -> softmax -> CE -> accuracy) tail.

    h2 [N, P], W [P, S], b [S], targets [N] int (-1 = dummy frame).
    Returns (loss f32 scalar, correct count int32 scalar); gradients flow to
    h2, W and b when autograd records."""
    if W.shape[-1] != S:
        raise ValueError(f"W has {W.shape[-1]} columns, expected S={S}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (h2, W, b)):
        return SoftmaxCeProjFused.apply(h2, W, b, targets, float(bias_mult),
                                        compute_dtype)
    loss, cnt, _ = softmax_ce_proj_fwd(h2, W, b, targets, bias_mult,
                                       compute_dtype, want_p=False)
    return loss, cnt


# ------------------------------------------------------------ the wide tail
def _no_tf32(compute_dtype) -> None:
    """float32 mode is true fp32: the products outside K4 run in cuBLAS and
    would round their operands to TF32 if it were on."""
    if compute_dtype == torch.float32 and \
            torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the wide softmax tail's products run in true fp32 in float32 "
            "mode: set torch.backends.cuda.matmul.allow_tf32 = False")


def wide_logits_reference(h2, W, b, bias_mult: float,
                          compute_dtype: torch.dtype = torch.float32,
                          x3: bool = False):
    """a = h . W + bias_mult * b [N, S] plainly (the twin's): in f32 on
    the storage dtype's values (x3: as three bf16 passes), the bias
    product added to the finished product, then rounded once to the
    storage dtype."""
    sdtype = storage_dtype(compute_dtype)
    a = product(h2.to(sdtype).float(), W.to(sdtype).float(), x3)
    a += bias_mult * b.float()
    return a.to(sdtype)


def wide_logits(h2, W, b, bias_mult: float,
                compute_dtype: torch.dtype = torch.float32):
    """a = h . W + bias_mult * b [N, S] in the storage dtype: the product
    outside K4 (an XLA product in the JAX package); K4's stats come from
    this rounded a. On the card in bf16 mode the engine on the tensor
    cores (`_launch_wide_logits`), in f32 mode cuBLAS in true f32 with the
    bias added in its epilogue, in 3x mode the engine's 3x instance; on
    the CPU the twin."""
    x3 = use3(compute_dtype)
    if not h2.is_cuda:
        return wide_logits_reference(h2, W, b, bias_mult, compute_dtype, x3)
    sdtype = storage_dtype(compute_dtype)
    if sdtype == torch.bfloat16 or x3:
        return _launch_wide_logits(h2.to(sdtype), W.to(sdtype), b,
                                   bias_mult)
    return torch.addmm(bias_mult * b.float(), h2.float(), W.float())


def wide_stats_reference(a, targets):
    """K4f's plain twin: (loss, count, off, ssum, pt) from the logits."""
    p, off, ssum = _row_probs(a.float())
    loss, cnt, pt = _loss_count(p, targets)
    return loss, cnt, off[:, 0], ssum[:, 0], pt


def softmax_ce_wide_fwd_reference(h2, W, b, targets, bias_mult: float,
                                  compute_dtype: torch.dtype = torch.float32,
                                  want_stats: bool = True, x3: bool = False):
    """The wide forward's plain-torch twin. h2 [N, P], W [P, S], b [S],
    targets [N] int (-1 = dummy). Returns (loss f32 scalar, count int32
    scalar, a [N, S] in the storage dtype, off, ssum, pt [N] f32 or three
    None without want_stats). x3: the logits product in three bf16
    passes."""
    a = wide_logits_reference(h2, W, b, bias_mult, compute_dtype, x3)
    loss, cnt, off, ssum, pt = wide_stats_reference(a, targets)
    if not want_stats:
        off = ssum = pt = None
    return loss, cnt, a, off, ssum, pt


def softmax_ce_wide_bwd_reference(a, h2, W, targets, off, ssum, pt, g,
                                  bias_mult: float,
                                  compute_dtype: torch.dtype = torch.float32,
                                  x3: bool = False):
    """The wide backward's plain-torch twin, from the forward's logits and
    stats and the loss cotangent g (a scalar tensor). Returns (dh [N, P] in
    h2's dtype, dW [P, S] f32, db [S] f32). x3: dW and dh in three bf16
    passes."""
    sdtype = storage_dtype(compute_dtype)
    dz = wide_dz_reference(a, targets, off, ssum, pt, g)
    dzc = dz.to(sdtype)
    dw = product(h2.to(sdtype).float().t(), dzc.float(), x3)
    return (wide_dh_reference(dzc, W, h2.dtype, compute_dtype, x3), dw,
            bias_mult * dz.sum(dim=0))


def wide_dz_reference(a, targets, off, ssum, pt, g):
    """dz [N, S] f32 (not rounded) of K4b's twin: p recomputed from the
    logits and the forward's stats, then `_tail_dz`."""
    p = safe_exp(a.float() - off[:, None]) / ssum[:, None]
    return _tail_dz(p, targets, pt, g)


def wide_dh_reference(dzc, W, out_dtype, compute_dtype, x3: bool = False):
    """dh = dzc . W^T plainly (the twin's): in f32 on the storage dtype's
    values (x3: as three bf16 passes), cast to h's dtype."""
    wc = W.to(storage_dtype(compute_dtype)).float()
    return product(dzc.float(), wc.t(), x3).to(out_dtype)


def _wide_dh(dzc, W, out_dtype, compute_dtype):
    """dh = dzc . W^T in h's dtype: the product outside K4b. On the card
    in bf16 mode the engine on the tensor cores (`_launch_wide_dh`), in
    f32 mode cuBLAS in true f32, in 3x mode the engine's 3x instance; on
    the CPU the twin."""
    sdtype = storage_dtype(compute_dtype)
    x3 = use3(compute_dtype)
    if dzc.is_cuda and (sdtype == torch.bfloat16 or x3):
        return _launch_wide_dh(dzc, W.to(sdtype), out_dtype)
    return wide_dh_reference(dzc, W, out_dtype, compute_dtype, x3)


def _check_stats(N, *stats):
    for t in stats:
        if t.dtype != torch.float32 or tuple(t.shape) != (N,):
            raise ValueError(f"the wide tail's stats must be [N] float32; "
                             f"got {t.dtype} {tuple(t.shape)}")


def _launch_wide_fwd(a, targets, want_stats: bool = True):
    """K4f alone on the logits a [N, S] (storage dtype, on the card).
    Returns (loss, count, off, ssum, pt), the stats None without
    want_stats."""
    from lstm_rnn_tpu_torch.ops import _build
    lib = _build.load()
    if a.dtype not in (torch.float32, torch.bfloat16) or a.dim() != 2:
        raise ValueError(f"a must be [N, S] float32 or bfloat16; got "
                         f"{a.dtype} {tuple(a.shape)}")
    N, S = a.shape
    dev = a.device
    ac = a.contiguous()
    tc = targets.to(device=dev, dtype=torch.int32).contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    stats = [torch.empty(N, **f32) for _ in range(3)] if want_stats \
        else [None] * 3
    part_loss = torch.empty(N, **f32)
    part_cnt = torch.empty(N, dtype=torch.int32, device=dev)
    loss = torch.empty((), **f32)
    cnt = torch.empty((), dtype=torch.int32, device=dev)
    err = lib.softmax_ce_wide_fwd(
        _ptr(ac), _ptr(tc), *[_ptr(t) if want_stats else None
                              for t in stats],
        _ptr(part_loss), _ptr(part_cnt), _ptr(loss), _ptr(cnt), N, S,
        int(a.dtype == torch.bfloat16), dev.index, _stream(a))
    _raise_on(err, "softmax_ce_wide_fwd launch")
    return (loss, cnt, *stats)


# K4b's tiles (csrc/softmax_ce_wide.cu: kBwdCols, kBwdPass, kBwdMaxPasses,
# kBwdRowsBf16, kBwdRowsF32, kBwdRows3x, kRowFloats; a CPU test reads
# them): a block owns 128 columns of S and a pass of 256 rows of dW (P <=
# 1,024: four passes), and walks its split of the rows in tiles of 64
# (bf16 and 3x) or 32 (f32) rows, each with its rows' eight constants
_BWD_COLS, _BWD_PASS, _BWD_MAX_PASSES = 128, 256, 4
_BWD_ROWS = {True: 64, False: 32}
_BWD_ROWS_3X = 64
# the 3x instance's splits hold at most 16 row tiles (1,024 rows): its
# tensor cores add each step's products without f32's round to nearest,
# an error that grows with the rows a split sums (2.5e-5 of dW's largest
# entry over 5,000 rows on an H100, 5.5e-6 over 1,024), where the splits'
# partials are summed in f32
_BWD_3X_TILES = 16
_BWD_ROW_FLOATS = 8
_BWD_MAX_SPLITS = 16


def wide_tail_fits(P: int) -> bool:
    """True when K4b takes a softmax layer fed by P units (P <= 1,024:
    four passes of 256 rows of dW); a wider net's wide softmax takes the
    materialized logits and K5, as the JAX package's does where its
    wide_plan refuses."""
    return 1 <= P <= _BWD_PASS * _BWD_MAX_PASSES


def wide_bwd_plan(N: int, P: int, S: int, bf16: bool,
                  sms: int = H100_SMS, x3: bool = False) -> dict:
    """K4b's launch at N rows, P and S: its passes over P, its row tiles,
    its row splits (one block an SM: the fewest splits, up to 16, that
    fill `sms` SMs in near-whole waves, none without rows; the 3x
    instance, x3, at least enough that none sums more than _BWD_3X_TILES
    tiles) and the packed h's shape ([hp_rows, hp_cols]; the rows'
    constants are [hp_rows, 8] f32; x3 packs h as two bf16 planes of that
    shape). Raises where the kernel does not take P."""
    passes = -(-P // _BWD_PASS)
    if not 1 <= passes <= _BWD_MAX_PASSES:
        raise ValueError(f"K4b takes 1 <= P <= {_BWD_PASS * _BWD_MAX_PASSES}"
                         f" ({_BWD_MAX_PASSES} passes of {_BWD_PASS}); got "
                         f"P={P}")
    rows = _BWD_ROWS_3X if x3 else _BWD_ROWS[bf16]
    ntiles = -(-N // rows)
    per = -(-S // _BWD_COLS) * passes
    best, fill = 1, 0.0
    for s in range(1, min(_BWD_MAX_SPLITS, ntiles) + 1):
        blocks = per * s
        f = blocks / (-(-blocks // sms) * sms)
        if f > fill + 0.02:
            best, fill = s, f
    if x3:
        best = max(best, -(-ntiles // _BWD_3X_TILES))
    tps = -(-ntiles // best)
    return dict(passes=passes, rows=rows, ntiles=ntiles,
                nsplit=-(-ntiles // tps), hp_rows=ntiles * rows,
                hp_cols=passes * _BWD_PASS)


# the launches of K4b's 3x instance among softmax_ce_wide_bwd's
WIDE_BWD_3X = types.SimpleNamespace(launches=0)


def _launch_wide_bwd(a, hc, targets, off, ssum, pt, g, bias_mult: float,
                     x3: bool = False):
    """K4b alone, one fused kernel: dz, dW = hc^T . dzc and db. a [N, S]
    and hc [N, P] in the storage dtype, on the card; x3 (f32): the 3x
    instance. Returns (dz [N, S] storage dtype, dW [P, S] f32, db [S]
    f32)."""
    from lstm_rnn_tpu_torch.ops import _build
    lib = _build.load()
    N, S = a.shape
    P = hc.shape[1]
    if hc.dtype != a.dtype or tuple(hc.shape) != (N, P):
        raise ValueError(f"h must be [N, P] in {a.dtype}; got {hc.dtype} "
                         f"{tuple(hc.shape)}")
    _check_stats(N, off, ssum, pt)
    dev = a.device
    bf16 = a.dtype == torch.bfloat16
    if x3 and bf16:
        raise ValueError("K4b's 3x instance takes float32 logits and h")
    plan = wide_bwd_plan(N, P, S, bf16, _sm_count(dev.index), x3)
    tc = targets.to(device=dev, dtype=torch.int32).contiguous()
    gc = g.to(device=dev, dtype=torch.float32).reshape(1).contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    ns = plan["nsplit"]
    dz = torch.empty((N, S), dtype=a.dtype, device=dev)
    hp = (torch.empty((2, plan["hp_rows"], plan["hp_cols"]),
                      dtype=torch.bfloat16, device=dev) if x3 else
          torch.empty((plan["hp_rows"], plan["hp_cols"]), dtype=a.dtype,
                      device=dev))
    rowc = torch.empty((plan["hp_rows"], _BWD_ROW_FLOATS), **f32)
    db_part = torch.empty((ns, S), **f32)
    w_part = torch.empty((ns, P * S), **f32) if ns > 1 else None
    dw = torch.empty((P, S), **f32)
    db = torch.empty(S, **f32)
    err = lib.softmax_ce_wide_bwd(
        _ptr(a.contiguous()), _ptr(hc.contiguous()), _ptr(tc),
        _ptr(off.contiguous()), _ptr(ssum.contiguous()),
        _ptr(pt.contiguous()), _ptr(gc), _ptr(dz), _ptr(hp), _ptr(rowc),
        _ptr(db_part),
        _ptr(w_part) if ns > 1 else None, _ptr(dw), _ptr(db), N, P, S, ns,
        ctypes.c_float(bias_mult), int(bf16), int(x3), dev.index,
        _stream(a))
    _raise_on(err, f"softmax_ce_wide_bwd{' 3x' if x3 else ''} launch")
    if x3:
        WIDE_BWD_3X.launches += 1
    return dz, dw, db


def _launch_wide_logits(hc, wc, b, bias_mult: float):
    """K4f's logits product in bf16 mode: a [N, S] bf16 = round(hc . wc +
    bias_mult * b) in csrc/gemm.cuh's engine (hc [N, P], wc [P, S] bf16 on
    the card, b [S]); with f32 hc and wc (3x mode), a [N, S] f32 in the
    engine's 3x instance."""
    from lstm_rnn_tpu_torch.ops import _build
    N, P = hc.shape
    S = wc.shape[1]
    dev = hc.device
    x3 = hc.dtype == torch.float32
    a = torch.empty((N, S), dtype=hc.dtype, device=dev)
    err = _build.load().softmax_ce_wide_logits(
        _ptr(hc.contiguous()), _ptr(wc.contiguous()),
        _ptr(b.to(device=dev, dtype=torch.float32).contiguous()), _ptr(a),
        N, P, S, ctypes.c_float(bias_mult), int(x3), dev.index, _stream(hc))
    _raise_on(err, "softmax_ce_wide_logits launch")
    count_launches("tail_logits", x3=x3)
    return a


def _launch_wide_dh(dzc, wc, out_dtype):
    """K4b's dh product in bf16 mode: dh [N, P] = dzc . wc^T in out_dtype
    (f32 sums, stored in f32 or rounded to bf16) in csrc/gemm.cuh's engine
    (dzc [N, S], wc [P, S] bf16 on the card); with f32 dzc and wc (3x
    mode), dh in f32 from the engine's 3x instance."""
    from lstm_rnn_tpu_torch.ops import _build
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dh is float32 or bfloat16, not {out_dtype}")
    N, S = dzc.shape
    P = wc.shape[0]
    dev = dzc.device
    x3 = dzc.dtype == torch.float32
    if x3 and (wc.dtype != torch.float32 or out_dtype != torch.float32):
        raise ValueError("the 3x dh product is float32 throughout")
    dh = torch.empty((N, P), dtype=out_dtype, device=dev)
    err = _build.load().softmax_ce_wide_dh(
        _ptr(dzc.contiguous()), _ptr(wc.contiguous()), _ptr(dh), N, P, S,
        int(out_dtype == torch.float32), int(x3), dev.index, _stream(dzc))
    _raise_on(err, "softmax_ce_wide_dh launch")
    count_launches("wide_dh", x3=x3)
    return dh


def softmax_ce_wide_fwd(h2, W, b, targets, bias_mult: float = 1.0,
                        compute_dtype: torch.dtype = torch.float32,
                        want_stats: bool = True):
    """(loss, count, a, off, ssum, pt): the logits product and K4f on a
    CUDA tensor, the twin on a CPU one. The stats are None without
    want_stats."""
    _check_compute_dtype(compute_dtype)
    _check(h2, W, b, targets)
    if not _on_cuda(h2, "softmax_ce_wide_fwd"):
        return softmax_ce_wide_fwd_reference(h2, W, b, targets, bias_mult,
                                             compute_dtype, want_stats,
                                             use3(compute_dtype))
    _no_tf32(compute_dtype)
    a = wide_logits(h2, W, b, bias_mult, compute_dtype)
    out = _launch_wide_fwd(a, targets, want_stats)
    softmax_ce_wide_fwd.launches += 1
    return out[0], out[1], a, *out[2:]


softmax_ce_wide_fwd.launches = 0


def softmax_ce_wide_bwd(a, h2, W, targets, off, ssum, pt, g,
                        bias_mult: float = 1.0,
                        compute_dtype: torch.dtype = torch.float32):
    """(dh, dW, db): K4b and the dh product on a CUDA tensor, the twin on a
    CPU one. a and the stats are the forward's; g is the loss cotangent (a
    scalar tensor on the same device: the kernel reads it, no host
    sync)."""
    _check_compute_dtype(compute_dtype)
    _check(h2, W, W.new_empty(W.shape[1]), targets)
    sdtype = storage_dtype(compute_dtype)
    if a.dtype != sdtype or tuple(a.shape) != (h2.shape[0], W.shape[1]):
        raise ValueError(f"a must be [N, S] in {sdtype}")
    x3 = use3(compute_dtype)
    if not _on_cuda(h2, "softmax_ce_wide_bwd"):
        return softmax_ce_wide_bwd_reference(a, h2, W, targets, off, ssum,
                                             pt, g, bias_mult,
                                             compute_dtype, x3)
    _no_tf32(compute_dtype)
    dz, dw, db = _launch_wide_bwd(a, h2.to(sdtype), targets, off, ssum, pt,
                                  g, bias_mult, x3)
    softmax_ce_wide_bwd.launches += 1
    return _wide_dh(dz, W, h2.dtype, compute_dtype), dw, db


softmax_ce_wide_bwd.launches = 0


class SoftmaxCeWideFused(torch.autograd.Function):
    """softmax_ce_wide_fused with gradients to h2, W and b. The residuals
    are the logits, h2, W, the targets and the three per-row stats."""

    @staticmethod
    def forward(ctx, h2, W, b, targets, bias_mult, compute_dtype):
        loss, cnt, a, off, ssum, pt = softmax_ce_wide_fwd(
            h2, W, b, targets, bias_mult, compute_dtype, want_stats=True)
        ctx.save_for_backward(a, h2, W, targets, off, ssum, pt)
        ctx.cfg = (bias_mult, compute_dtype)
        ctx.mark_non_differentiable(cnt)
        return loss, cnt

    @staticmethod
    def backward(ctx, g_loss, _g_cnt):
        saved = ctx.saved_tensors  # a, h2, W, targets, off, ssum, pt
        dh, dw, db = softmax_ce_wide_bwd(*saved, g_loss, *ctx.cfg)
        return dh, dw.to(saved[2].dtype), db, None, None, None


def softmax_ce_wide_fused(h2, W, b, targets, S: int, bias_mult: float,
                          compute_dtype: torch.dtype = torch.float32):
    """The wide (LVCSR-scale) tail: softmax_ce_proj_fused's contract for
    any S. Returns (loss f32 scalar, correct count int32 scalar);
    gradients flow to h2, W and b when autograd records, else the forward
    runs alone and keeps no stats."""
    if W.shape[-1] != S:
        raise ValueError(f"W has {W.shape[-1]} columns, expected S={S}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (h2, W, b)):
        return SoftmaxCeWideFused.apply(h2, W, b, targets, float(bias_mult),
                                        compute_dtype)
    loss, cnt, *_ = softmax_ce_wide_fwd(h2, W, b, targets, bias_mult,
                                        compute_dtype, want_stats=False)
    return loss, cnt


# ------------------------------------------------- the 3x projection tail
def _tail3x_grads(h2, W, dz, bias_mult: float):
    """(dh [N, P], dW [P, S], db [S]) of the 3x tail from dz [N, S] f32:
    dh = dz . W^T and dW = h2^T . dz in the engine's 3x tail_dh and
    tail_dW (split over the N rows; the twins on the CPU), db = bias_mult
    * sum dz."""
    N, P = h2.shape
    S = W.shape[1]
    h2, W, dz = h2.contiguous(), W.contiguous(), dz.contiguous()
    dh = gemm("tail_dh", [View(dz, 0, S, N, S)], [View(W, 0, S, P, S)], N, P,
              S, x3=True)
    dw = gemm("tail_dW", [View(h2, 0, P, N, P)], [View(dz, 0, S, N, S)], P, S,
              N, nsplit=splits(N), x3=True)[0]
    return dh, dw, bias_mult * dz.sum(dim=0)


class _Tail3xProduct(torch.autograd.Function):
    """The softmax layer's product a = h2 . W + bias_mult * b [N, S] f32
    of the 3x tail, with its gradients (`_tail3x_grads`)."""

    @staticmethod
    def forward(ctx, h2, W, b, bias_mult):
        ctx.save_for_backward(h2, W)
        ctx.bias_mult = bias_mult
        return wide_logits(h2, W, b, bias_mult, torch.float32)

    @staticmethod
    def backward(ctx, da):
        h2, W = ctx.saved_tensors
        dh, dw, db = _tail3x_grads(h2, W, da.float(), ctx.bias_mult)
        return dh.to(h2.dtype), dw.to(W.dtype), db, None


def softmax_ce_3x_fused(h2, W, b, targets, S: int, bias_mult: float):
    """K3's tail under --f32_matmul 3x (the JAX kernels' _fwd_proj_kernel
    and _bwd_proj_kernel with use3): the logits in the engine's 3x
    tail_logits, the CURRENNT softmax, loss and count in K5f, dz in K5b,
    then dh and dW in the engine's 3x tail_dh and tail_dW. Returns (loss
    f32 scalar, correct count int32 scalar); gradients flow to h2, W and b
    when autograd records."""
    if W.shape[-1] != S:
        raise ValueError(f"W has {W.shape[-1]} columns, expected S={S}")
    if not use3(torch.float32):
        raise RuntimeError("the 3x tail runs with --f32_matmul 3x on "
                           "(ops/gemm.py F32_MATMUL_3X)")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (h2, W, b)):
        a = _Tail3xProduct.apply(h2, W, b, float(bias_mult))
    else:
        a = wide_logits(h2, W, b, bias_mult, torch.float32)
    return softmax_ce_fused(a, targets, S, torch.float32)


# ----------------------------------------------------------- the plain tail
def plain_fwd_reference(a, targets,
                        compute_dtype: torch.dtype = torch.float32,
                        want_p: bool = True):
    """K5f's plain twin: (loss f32 scalar, count int32 scalar, p [N, S] in
    the storage dtype or None) from the logits a [N, S]; the count from
    the f32 p, before it is rounded for the store."""
    p, _, _ = _row_probs(a.float())
    loss, cnt, _ = _loss_count(p, targets)
    return loss, cnt, (p.to(storage_dtype(compute_dtype)) if want_p
                       else None)


# K5f's bodies (csrc/softmax_ce_plain.cu: kPlainThreads, kWarpRowMaxS,
# kWarpHoldNarrow, kWarpHold, kBlockHold; a CPU test reads them): a warp a
# row, holding up to 8 values a lane up to 256 classes and 32 up to 1,024;
# the 256-thread block a row, holding up to 40 values a thread, up to
# 10,240; three passes over wider rows
_PLAIN_THREADS, _PLAIN_WARP_MAX_S = 256, 1024
_PLAIN_WARP_HOLD_NARROW, _PLAIN_WARP_HOLD, _PLAIN_BLOCK_HOLD = 8, 32, 40


def _row_vec_elems(addr: int, row_bytes: int, elem: int) -> int:
    """softmax_common.cuh's row_vec_elems: the widest vector, in elements
    of `elem` bytes and up to 16 bytes, that every row allows: the lowest
    set bit of (base | row bytes | 16)."""
    bits = addr | row_bytes | 16
    return (bits & -bits) // elem


def plain_fwd_plan(S: int, a_addr: int, p_addr: int | None = None,
                   p_itemsize: int = 4) -> tuple[str, int, int]:
    """K5f's launch over rows of S classes, as softmax_ce_plain.cu's
    plain_fwd decides it: (body, hold, E). body is "warp" or "block" (the
    row held in registers, `hold` values a thread) or "passes" (hold 0);
    E the f32 logits a vector load (and p's values a store): the widest
    that the base and row pitch of a (at a_addr) and of p (at p_addr, None
    without p) allow."""
    if S <= 32 * _PLAIN_WARP_HOLD_NARROW:
        body, hold = "warp", _PLAIN_WARP_HOLD_NARROW
    elif S <= _PLAIN_WARP_MAX_S:
        body, hold = "warp", _PLAIN_WARP_HOLD
    elif S <= _PLAIN_THREADS * _PLAIN_BLOCK_HOLD:
        body, hold = "block", _PLAIN_BLOCK_HOLD
    else:
        body, hold = "passes", 0
    E = _row_vec_elems(a_addr, 4 * S, 4)
    if p_addr is not None:
        E = min(E, _row_vec_elems(p_addr, p_itemsize * S, p_itemsize))
    return body, hold, min(E, 4)


def _check_logits(a, targets):
    if a.dim() != 2 or tuple(targets.shape) != (a.shape[0],):
        raise ValueError(f"a must be [N, S] and targets [N]; got "
                         f"{tuple(a.shape)} and {tuple(targets.shape)}")


def softmax_ce_fwd(a, targets, compute_dtype: torch.dtype = torch.float32,
                   want_p: bool = True):
    """K5f: (loss, count, p or None) from the logits a [N, S] (read in
    f32), p in the storage dtype when want_p; the CUDA kernel on a CUDA
    tensor, the twin on a CPU one."""
    _check_compute_dtype(compute_dtype)
    _check_logits(a, targets)
    if not _on_cuda(a, "softmax_ce_fwd"):
        return plain_fwd_reference(a, targets, compute_dtype, want_p)
    from lstm_rnn_tpu_torch.ops import _build
    lib = _build.load()
    N, S = a.shape
    sdtype = storage_dtype(compute_dtype)
    dev = a.device
    ac = a.float().contiguous()
    tc = targets.to(device=dev, dtype=torch.int32).contiguous()
    p = torch.empty((N, S), dtype=sdtype, device=dev) if want_p else None
    part_loss = torch.empty(N, dtype=torch.float32, device=dev)
    part_cnt = torch.empty(N, dtype=torch.int32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    cnt = torch.empty((), dtype=torch.int32, device=dev)
    err = lib.softmax_ce_plain_fwd(
        _ptr(ac), _ptr(tc), _ptr(p) if want_p else None, _ptr(part_loss),
        _ptr(part_cnt), _ptr(loss), _ptr(cnt), N, S,
        int(sdtype == torch.bfloat16), dev.index, _stream(a))
    _raise_on(err, "softmax_ce_plain_fwd launch")
    softmax_ce_fwd.launches += 1
    return loss, cnt, p


softmax_ce_fwd.launches = 0


def softmax_ce_bwd(p, targets, g):
    """K5b: dz [N, S] f32 from the forward's stored p [N, S] (f32 or
    bf16) and the loss cotangent g (a scalar tensor on p's device: the
    kernel reads it, no host sync); the CUDA kernel on a CUDA tensor, the
    twin on a CPU one."""
    _check_logits(p, targets)
    if p.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"p must be float32 or bfloat16, got {p.dtype}")
    if not _on_cuda(p, "softmax_ce_bwd"):
        return plain_dz_reference(p, targets, g)
    from lstm_rnn_tpu_torch.ops import _build
    lib = _build.load()
    N, S = p.shape
    dev = p.device
    tc = targets.to(device=dev, dtype=torch.int32).contiguous()
    gc = g.to(device=dev, dtype=torch.float32).reshape(1).contiguous()
    dz = torch.empty((N, S), dtype=torch.float32, device=dev)
    err = lib.softmax_ce_plain_bwd(
        _ptr(p.contiguous()), _ptr(tc), _ptr(gc), _ptr(dz), N, S,
        int(p.dtype == torch.bfloat16), dev.index, _stream(p))
    _raise_on(err, "softmax_ce_plain_bwd launch")
    softmax_ce_bwd.launches += 1
    return dz


softmax_ce_bwd.launches = 0


class SoftmaxCeFused(torch.autograd.Function):
    """softmax_ce_fused with the gradient to the logits (the JAX package's
    custom VJP): the forward stores p in the storage dtype, the backward
    is K5b from it; dz in a's dtype."""

    @staticmethod
    def forward(ctx, a, targets, compute_dtype):
        loss, cnt, p = softmax_ce_fwd(a, targets, compute_dtype, want_p=True)
        ctx.save_for_backward(p, targets)
        ctx.a_dtype = a.dtype
        ctx.mark_non_differentiable(cnt)
        return loss, cnt

    @staticmethod
    def backward(ctx, g_loss, _g_cnt):
        p, targets = ctx.saved_tensors
        return softmax_ce_bwd(p, targets, g_loss).to(ctx.a_dtype), None, None


def softmax_ce_fused(a, targets, S: int,
                     compute_dtype: torch.dtype = torch.float32):
    """The plain tail (K5) from materialized logits a [N, S] (exact width;
    the JAX call's 128-lane padding is a TPU tiling rule) and targets [N]
    int (-1 = dummy frame). Returns (loss f32 scalar, correct count int32
    scalar); the gradient flows to a when autograd records, else the
    forward runs alone and stores no p."""
    if a.shape[-1] != S:
        raise ValueError(f"a has {a.shape[-1]} columns, expected S={S}")
    if torch.is_grad_enabled() and a.requires_grad:
        return SoftmaxCeFused.apply(a, targets, compute_dtype)
    loss, cnt, _ = softmax_ce_fwd(a, targets, compute_dtype, want_p=False)
    return loss, cnt
