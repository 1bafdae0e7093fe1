"""The fused classification tail on the GPU: identity feedforward ->
CURRENNT softmax -> multiclass cross-entropy -> accuracy count.

Counterpart of lstm_rnn_tpu/ops/softmax_ce.py (`softmax_ce_proj_fused`,
whose custom VJP launches `_fwd_proj_kernel` and `_bwd_proj_kernel`). Two
kernels, in csrc/softmax_ce.cu, each behind one wrapper with a launch
count:

- `softmax_ce_proj_fwd`: logits = h . W + bias_mult * b in the kernel's
  own tiled product, the CURRENNT softmax (offset (min + max) / 2 with the
  max floored at REAL_MIN, safeExp), loss = sum of -log max(p[target],
  REAL_MIN) and the first-argmax == target count over rows with
  target >= 0, and p [N, S] when the caller trains (want_p);
- `softmax_ce_proj_bwd`: dz = g p (onehot (-1/p_c) - s), masked, from the
  stored p; dh = dz . W^T, dW = h^T . dz, db = bias_mult * sum dz.

`softmax_ce_proj_fused` with gradients goes through SoftmaxCeProjFused
(forward with want_p, backward kernel); without, it runs the forward with
want_p off. Widths are exact: W [P, S], b [S]; the JAX package's 128-lane
padding of S and P is a TPU tiling rule the kernels do not need.

Precision: float32 mode is true f32. bfloat16 mode rounds h and W to bf16
(f32 accumulation), stores p in bf16, rounds dz to bf16 before the two
products (db sums the unrounded dz) and returns dh in bf16, as the JAX
kernels do. On a CUDA tensor each wrapper launches its kernel or raises;
on a CPU tensor it runs its plain twin.
"""

from __future__ import annotations

import ctypes

import torch

from lstm_rnn_tpu_torch.ops.activations import REAL_MIN, safe_exp
from lstm_rnn_tpu_torch.ops.lstm_cell import (_check_compute_dtype, _on_cuda,
                                              _ptr, _raise_on, _stream,
                                              storage_dtype)


def softmax_ce_fwd_reference(h2, W, b, targets, bias_mult: float,
                             compute_dtype: torch.dtype = torch.float32,
                             want_p: bool = True):
    """The forward kernel's plain-torch twin. h2 [N, P], W [P, S], b [S],
    targets [N] int (-1 = dummy). Returns (loss f32 scalar, count int32
    scalar, p [N, S] in the storage dtype or None)."""
    sdtype = storage_dtype(compute_dtype)
    a = torch.matmul(h2.to(sdtype).float(), W.to(sdtype).float())
    a = a + bias_mult * b.float()
    mn = a.amin(dim=-1, keepdim=True)
    mx = torch.clamp_min(a.amax(dim=-1, keepdim=True), REAL_MIN)
    e = safe_exp(a - 0.5 * (mn + mx))
    p = e / e.sum(dim=-1, keepdim=True)
    tc = targets.long()
    valid = tc >= 0
    p_t = torch.where(valid, p.gather(1, tc.clamp_min(0)[:, None])[:, 0],
                      torch.zeros_like(p[:, 0]))
    loss = -(torch.log(torch.clamp_min(p_t, REAL_MIN)) * valid).sum()
    # torch.argmax returns the first maximal index, as the reference does
    cnt = ((p.argmax(dim=-1) == tc) & valid).sum().to(torch.int32)
    return loss, cnt, (p.to(sdtype) if want_p else None)


def softmax_ce_bwd_reference(p, h2, W, targets, g, bias_mult: float,
                             compute_dtype: torch.dtype = torch.float32):
    """The backward kernel's plain-torch twin, from the stored p (storage
    dtype) and the loss cotangent g (a scalar tensor). Returns (dh [N, P]
    in the storage dtype, dW [P, S] f32, db [S] f32)."""
    sdtype = storage_dtype(compute_dtype)
    pf = p.float()
    tc = targets.long()
    valid = (tc >= 0).float()[:, None]
    onehot = torch.zeros_like(pf).scatter_(
        1, tc.clamp_min(0)[:, None], 1.0) * valid
    p_t = (pf * onehot).sum(dim=-1, keepdim=True)
    inv = -1.0 / torch.clamp_min(p_t, REAL_MIN)
    dz = pf * (onehot * inv - p_t * inv) * valid * g.float()
    dzc = dz.to(sdtype).float()
    dh = torch.matmul(dzc, W.to(sdtype).float().t()).to(sdtype)
    dw = torch.matmul(h2.to(sdtype).float().t(), dzc)
    return dh, dw, bias_mult * dz.sum(dim=0)


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
    from lstm_rnn_tpu_torch.ops import _build
    lib = _build.load()
    N, P = h2.shape
    S = W.shape[1]
    need = lib.softmax_ce_smem(S) + 16 * 1024
    have = torch.cuda.get_device_properties(h2.device) \
        .shared_memory_per_block_optin
    if need > have:
        raise NotImplementedError(
            f"softmax_ce_proj_fwd: S={S} classes need {need} bytes of "
            f"shared memory per block, the card has {have}; the wide tail "
            f"that serves such nets is not ported yet (ROADMAP K4)")
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
    from lstm_rnn_tpu_torch.ops import _build
    lib = _build.load()
    N, P = h2.shape
    S = W.shape[1]
    sdtype = storage_dtype(compute_dtype)
    if p.dtype != sdtype or tuple(p.shape) != (N, S):
        raise ValueError(f"p must be [N, S] in {sdtype}")
    dev = h2.device
    hc = h2.to(sdtype).contiguous()
    wc = W.to(sdtype).contiguous()
    tc = targets.to(device=dev, dtype=torch.int32).contiguous()
    gc = g.to(device=dev, dtype=torch.float32).reshape(1).contiguous()
    nblk = (N + 63) // 64
    nsplit = lib.softmax_ce_splits(N)
    f32 = dict(dtype=torch.float32, device=dev)
    dz = torch.empty((N, S), dtype=sdtype, device=dev)
    db_part = torch.empty((nblk, S), **f32)
    w_part = torch.empty((nsplit, P * S), **f32)
    dh = torch.empty((N, P), dtype=sdtype, device=dev)
    dw = torch.empty((P, S), **f32)
    db = torch.empty(S, **f32)
    err = lib.softmax_ce_bwd(
        _ptr(p.contiguous()), _ptr(hc), _ptr(wc), _ptr(tc), _ptr(gc),
        _ptr(dz), _ptr(db_part), _ptr(w_part), _ptr(dh), _ptr(dw), _ptr(db),
        N, P, S, ctypes.c_float(bias_mult), int(sdtype == torch.bfloat16),
        dev.index, _stream(h2))
    _raise_on(err, "softmax_ce_bwd launch")
    softmax_ce_proj_bwd.launches += 1
    return dh, dw, db


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
