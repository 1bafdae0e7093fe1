"""The LSTM layer's forward on the GPU: the wrapper of the Hopper kernel.

Counterpart of lstm_rnn_tpu/ops/lstm_cell.py (`lstm_scan_fused`, whose
inference primal launches `_fwd_kernel` with save=False). The kernel lives
in csrc/lstm_fwd.cu and runs in two launches per layer: a tiled input
projection into an f32 scratch buffer, then the recurrence over both
directions (see the note at the top of the source).

Shapes, as in the JAX package: x [T, B, P] in natural time order,
w_in [D, P, 4H], w_rec [D, H, 4H], peep [D, 3, H] f32, bias [D, 4H] f32,
lengths [B] int32 (each row's valid frames are a prefix). Gate order
[ni, ig, fg, og], peephole order [ig, fg, og]. Returns h [T, B, D*H] as
[fw | bw] per frame, in the storage dtype (bf16 in bfloat16 mode).

Precision. float32 mode: true f32 products and the CURRENNT forms of
logistic (saturating at +-EXP_LIMIT) and tanh (2*logistic(2x) - 1).
bfloat16 mode: x, W_in, W_rec and the h fed back into the recurrent
product are bf16; state and accumulation stay f32; sigma and tanh are the
plain functions (the JAX kernel's `_cell_acts(fast=True)`); h is stored in
bf16.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it runs the plain twin `lstm_scan_reference`. Forward only: the backward
kernel comes with the training step.
"""

from __future__ import annotations

import ctypes

import torch

from lstm_rnn_tpu_torch.models.feedforward import round_operand
from lstm_rnn_tpu_torch.ops.activations import logistic, tanh2

COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def storage_dtype(compute_dtype: torch.dtype) -> torch.dtype:
    return torch.bfloat16 if compute_dtype == torch.bfloat16 else torch.float32


def lstm_cell_step(a, c, peep, fast: bool):
    """CURRENNT cell (ComputeBlockOutputFn, LstmLayer.cu:47-138) from
    complete gate preactivations a [D, B, 4, H] and cell state c [D, B, H];
    peep [D, 3, H]. fast=True takes the plain sigma/tanh of bf16 mode.
    Returns (h_new, c_new), unmasked."""
    sig, tanh = (torch.sigmoid, torch.tanh) if fast else (logistic, tanh2)
    ni = tanh(a[:, :, 0])
    ig = sig(a[:, :, 1] + c * peep[:, None, 0])
    fg = sig(a[:, :, 2] + c * peep[:, None, 1])
    c_new = ni * ig + fg * c
    og = sig(a[:, :, 3] + c_new * peep[:, None, 2])  # peephole from NEW c
    return tanh(c_new) * og, c_new


def lstm_scan_reference(x, w_in, w_rec, peep, bias, lengths,
                        bias_mult: float = 1.0,
                        compute_dtype: torch.dtype = torch.float32):
    """The kernel's plain-torch twin: a Python time loop over the same
    math, rounding at the same points. Direction 1 walks time descending
    over the natural-order arrays, as the kernel does."""
    T, B, P = x.shape
    D, _, G = w_in.shape
    H = G // 4
    fast = compute_dtype == torch.bfloat16
    sdtype = storage_dtype(compute_dtype)
    a = torch.matmul(round_operand(x.reshape(T * B, P), compute_dtype),
                     round_operand(w_in, compute_dtype))
    a = (a + bias_mult * bias[:, None]).view(D, T, B, G)
    w = round_operand(w_rec, compute_dtype)
    valid = (torch.arange(T, device=x.device)[:, None]
             < lengths.to(x.device)[None, :]).float()
    h = torch.zeros(D, B, H, device=x.device)
    c = torch.zeros(D, B, H, device=x.device)
    out = torch.empty(T, B, D * H, dtype=sdtype, device=x.device)
    for s in range(T):
        ts = (s, T - 1 - s)[:D]
        g = torch.stack([a[d, t] for d, t in enumerate(ts)])
        g = g + torch.bmm(round_operand(h, compute_dtype), w)
        h_new, c_new = lstm_cell_step(g.view(D, B, 4, H), c, peep, fast)
        m = torch.stack([valid[t] for t in ts])[..., None]
        h = (h_new * m).to(sdtype)
        c = c_new * m
        for d, t in enumerate(ts):
            out[t, :, d * H:(d + 1) * H] = h[d]
        h = h.float()
    return out


def _check_shapes(x, w_in, w_rec, peep, bias, lengths):
    if x.dim() != 3 or w_in.dim() != 3:
        raise ValueError(f"x must be [T, B, P] and w_in [D, P, 4H]; got "
                         f"{tuple(x.shape)} and {tuple(w_in.shape)}")
    T, B, P = x.shape
    D, P2, G = w_in.shape
    H = G // 4
    if T < 1 or B < 1 or P < 1 or D not in (1, 2) or H < 1 or G != 4 * H:
        raise ValueError(f"unsupported LSTM shapes x={tuple(x.shape)}, "
                         f"w_in={tuple(w_in.shape)}")
    want = {"w_in": ((D, P, G), w_in), "w_rec": ((D, H, G), w_rec),
            "peep": ((D, 3, H), peep), "bias": ((D, G), bias),
            "lengths": ((B,), lengths)}
    for name, (shape, t) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape} for x {tuple(x.shape)}")


def lstm_scan_fused(x, w_in, w_rec, peep, bias, lengths,
                    bias_mult: float = 1.0,
                    compute_dtype: torch.dtype = torch.float32):
    """One (B)LSTM layer's forward: the CUDA kernel on a CUDA tensor, the
    twin on a CPU tensor. See the module docstring for shapes."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be float32 or bfloat16, "
                         f"got {compute_dtype}")
    args = (x, w_in, w_rec, peep, bias, lengths)
    if any(t.requires_grad for t in args):
        raise RuntimeError(
            "lstm_scan_fused is forward-only: its backward kernel comes with "
            "the training step (ROADMAP.md); run under torch.inference_mode()")
    _check_shapes(*args)
    if x.device.type == "cpu":
        return lstm_scan_reference(*args, bias_mult, compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_scan_fused runs on CUDA or CPU, not "
                         f"{x.device}")
    _check_cuda_operands(*args)
    a = _launch_proj(x.to(compute_dtype), w_in.to(compute_dtype), bias,
                     bias_mult)
    out = _launch_rec(a, w_rec.to(compute_dtype), peep, lengths)
    lstm_scan_fused.launches += 1
    return out


# Kernel launches on the main path (chip_smoke.py resets and reads it).
lstm_scan_fused.launches = 0


def _check_cuda_operands(x, w_in, w_rec, peep, bias, lengths):
    named = {"x": x, "w_in": w_in, "w_rec": w_rec, "peep": peep,
             "bias": bias, "lengths": lengths}
    for name, t in named.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("x", "w_in", "w_rec"):
        if named[name].dtype not in COMPUTE_DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{named[name].dtype}")
    for name in ("peep", "bias"):
        if named[name].dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got "
                            f"{named[name].dtype}")
    if lengths.dtype != torch.int32:
        raise TypeError(f"lengths must be int32, got {lengths.dtype}")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _raise_on(err: int, what: str) -> None:
    if err:
        from lstm_rnn_tpu_torch.ops import _build
        raise RuntimeError(f"{what} failed: CUDA error {err} "
                           f"({_build.load().lstm_err_str(err).decode()})")


def _launch_proj(x, w_in, bias, bias_mult: float):
    """Input projection a[d] = x . w_in[d] + bias_mult * bias[d] into an
    f32 [D, T, B, 4H] buffer. x and w_in share the compute dtype."""
    from lstm_rnn_tpu_torch.ops import _build
    T, B, P = x.shape
    D, _, G = w_in.shape
    a = torch.empty((D, T, B, G), dtype=torch.float32, device=x.device)
    err = _build.load().lstm_fwd_proj(
        _ptr(x), _ptr(w_in), _ptr(bias), _ptr(a), T * B, P, G, D,
        ctypes.c_float(bias_mult), int(x.dtype == torch.bfloat16),
        x.device.index, ctypes.c_void_p(
            torch.cuda.current_stream(x.device).cuda_stream))
    _raise_on(err, "lstm_fwd_proj launch")
    return a


def _launch_rec(a, w_rec, peep, lengths):
    """Recurrence over the projected a [D, T, B, 4H] -> h [T, B, D*H] in
    the storage dtype of w_rec's compute dtype."""
    from lstm_rnn_tpu_torch.ops import _build
    D, T, B, G = a.shape
    H = G // 4
    bf16 = w_rec.dtype == torch.bfloat16
    # the kernel reads four adjacent W_rec entries in one vector load
    if w_rec.data_ptr() % (4 * w_rec.element_size()):
        raise ValueError(f"w_rec must be {4 * w_rec.element_size()}-byte "
                         f"aligned (a contiguous copy is)")
    out = torch.empty((T, B, D * H),
                      dtype=torch.bfloat16 if bf16 else torch.float32,
                      device=a.device)
    err = _build.load().lstm_fwd_rec(
        _ptr(a), _ptr(w_rec), _ptr(peep), _ptr(lengths), _ptr(out),
        T, B, H, D, int(bf16), a.device.index,
        ctypes.c_void_p(torch.cuda.current_stream(a.device).cuda_stream))
    _raise_on(err, "lstm_fwd_rec launch")
    return out
