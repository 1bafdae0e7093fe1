"""LSTM / bidirectional LSTM with forget gates and peepholes.

Counterpart of lstm_rnn_tpu/models/lstm.py; semantics of
`currennt_lib/src/layers/LstmLayer.cu` (cell: ComputeBlockOutputFn,
LstmLayer.cu:47-138; padding slots force h = c = 0; a bidirectional layer
of size L runs two halves of H = L/2 cells, the backward half walking time
in reverse, output [fw | bw] per frame).

Parameters, as in the JAX package (gate order [ni, ig, fg, og], peephole
order [ig, fg, og]):
    {"W_in": [D, P, 4, H], "W_rec": [D, H, 4, H], "b": [D, 4, H],
     "peep": [D, 3, H]}

Routing in `lstm_forward` and `lstm_forward_streaming` (one chunk of a
unidirectional layer from a carried state): backend "auto" or "pallas"
(the flag keeps its spelling; it names the Hopper kernels) goes through
`lstm_scan_fused` (streaming: `lstm_scan_fused_carry`, inference only),
which launches the CUDA kernels for a CUDA tensor and runs their twins
for a CPU tensor, and whose gradient is the BPTT kernel; backend "scan"
runs `_lstm_scan` on either device, and autograd differentiates it.
Where no CTA of the recurrence kernels takes the width (`kernel_route`:
ops/lstm_cell.py recurrence_fits, from the plan alone; H >= 801 per
direction with autograd, H >= 1,025 without), "auto" takes the scan
route and an explicit "pallas" raises, as the JAX package's VMEM guard
does (lstm_rnn_tpu/models/lstm.py: "auto" falls back to lax.scan). Both
routes clip the gate deltas to +-1 (the reference's limitedError): the
scan route through grad_clip on each preactivation and the split
og-peephole path of `lstm_cell_step`, so that it reproduces the BPTT
kernel's deltas and is an independent check of it.

`remat_blocks=K` (the CLI's --remat_blocks, training only) checkpoints the
recurrence in k = min(K, T) equal time blocks, T padded with zero-mask
steps to a multiple of k and the outputs sliced back: backward then holds
one block's intermediates plus the layer's inputs and the k block-boundary
carries, and recomputes each block's forward once. k <= 1 is no remat.
The scan route checkpoints `_lstm_scan` block by block, as the JAX package
does. The kernel route does too, where the JAX package does not: there
remat forces the scan backend and refuses an explicit pallas one
(lstm_rnn_tpu/models/lstm.py:218-224, :247-252), because its Mosaic
kernel keeps its own residuals for the whole sequence and takes no carry.
The port's carry kernels take one, so each block of each direction runs
as a checkpointed `lstm_scan_fused_carry` call (its forward with residuals
and its BPTT, K6b) in the wavefront that sequence parallelism runs
(models/blocks.py), on the one device. The port's scan route is a Python
time loop, the plain twin, which trains more than 100x slower than the
kernels on an H100 (PERF.md): it stays off every path that a card runs.
The values and gradients are the JAX package's: K checkpointed time
blocks. Without autograd the flag changes nothing (no backward, so no
residuals), and the kernel route runs the inference kernel on the whole
layer.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from lstm_rnn_tpu_torch.models.blocks import fused_wavefront, pad_time
from lstm_rnn_tpu_torch.models.feedforward import round_operand
from lstm_rnn_tpu_torch.ops.activations import grad_clip
from lstm_rnn_tpu_torch.ops.lstm_cell import (lstm_cell_step,
                                              lstm_scan_fused,
                                              lstm_scan_fused_carry,
                                              recurrence_fits, storage_dtype)

BACKENDS = ("auto", "scan", "pallas")


def kernel_route(backend: str, H: int, compute_dtype: torch.dtype,
                 need_grad: bool) -> bool:
    """True when a layer of H cells per direction takes the recurrence
    kernels: backend "auto" or "pallas" and a width the kernels take
    (recurrence_fits). "auto" takes the scan route otherwise; an explicit
    "pallas" raises there."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "scan":
        return False
    if recurrence_fits(H, compute_dtype, need_grad):
        return True
    if backend == "pallas":
        raise ValueError(
            f"lstm_backend=pallas: a layer of H={H} cells per direction "
            f"({'training' if need_grad else 'inference'}, "
            f"{str(compute_dtype).removeprefix('torch.')}) is wider than any "
            f"CTA of the recurrence kernels takes; use lstm_backend=auto "
            f"(falls back to the scan) or scan")
    return False


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _lstm_scan(acts, w_rec, peep, mask, compute_dtype: torch.dtype,
               init=None, return_carry: bool = False, remat_blocks: int = 0):
    """The scan path: a Python time loop over both (or one) directions,
    differentiable by autograd.

    acts [T, D, B, 4, H] input projections + bias, with the backward
    direction already time-reversed; w_rec [D, H, 4, H]; peep [D, 3, H];
    mask [T, D, B, 1] (1.0 valid / 0.0 pad, any pattern). Returns
    [T, D, B, H] in the storage dtype. Rounds where the kernel does: in
    bfloat16 mode the fed-back h and the output are bf16.

    init: an explicit starting state (h, c), [D, B, H] f32 each, and
    return_carry=True also returns the final (h, c), h before storage
    rounding: the streaming hooks (lstm_forward_streaming carries the
    state from chunk to chunk).

    remat_blocks=K: the scan in k = min(K, T) checkpointed time blocks
    (see the module docstring); return_carry then raises, because the
    padding steps would zero the returned state."""
    T, D, B, _, H = acts.shape
    k = min(remat_blocks, T) if remat_blocks else 0
    if k > 1:
        if return_carry:
            raise ValueError("return_carry is not supported with "
                             "remat_blocks")
        return _remat_scan(acts, w_rec, peep, mask, compute_dtype, k, init)
    fast = compute_dtype == torch.bfloat16
    sdtype = storage_dtype(compute_dtype)
    w = round_operand(w_rec, compute_dtype).reshape(D, H, 4 * H)
    if init is None:
        h = acts.new_zeros(D, B, H)
        c = acts.new_zeros(D, B, H)
    else:
        h = round_operand(init[0], compute_dtype)  # as the product reads it
        c = init[1]
    ys = []
    for t in range(T):
        a = acts[t] + torch.bmm(h, w).view(D, B, 4, H)
        h_new, c_new, _ = lstm_cell_step(a, c, peep, fast, grad_clip)
        h_m = h_new * mask[t]
        ys.append(h_m.to(sdtype))
        h = ys[-1].to(acts.dtype)
        c = c_new * mask[t]
    ys = torch.stack(ys)
    return (ys, (h_m, c)) if return_carry else ys


def _remat_scan(acts, w_rec, peep, mask, compute_dtype, k: int, init):
    """`_lstm_scan` over k checkpointed time blocks of ceil(T / k) steps,
    T padded with zero-mask steps (after every real frame of each scan
    order, where the state is zero anyway) and the output sliced back."""
    _, D, B, _, H = acts.shape
    acts, _, mask, T = pad_time(acts, None, mask, k)
    tb = acts.shape[0] // k

    def block(a, m, h0, c0):
        ys, (h, c) = _lstm_scan(a, w_rec, peep, m, compute_dtype,
                                init=(h0, c0), return_carry=True)
        return ys, h, c

    h, c = init if init is not None else (acts.new_zeros(D, B, H),
                                          acts.new_zeros(D, B, H))
    ys = []
    for i in range(k):
        y, h, c = checkpoint(block, acts[i * tb:(i + 1) * tb],
                             mask[i * tb:(i + 1) * tb], h, c,
                             use_reentrant=False, preserve_rng_state=False)
        ys.append(y)
    return torch.cat(ys)[:T]


def _remat_fused(params, x, pattypes, bias_mult: float, bidirectional: bool,
                 k: int, compute_dtype: torch.dtype):
    """The kernel route under remat: the layer in k checkpointed time
    blocks of ceil(T / k) frames, every block on x's device, through the
    carry kernels' wavefront. Returns [T, B, L] in the storage dtype."""
    T = x.shape[0]
    x, _, pattypes, _ = pad_time(x, None, pattypes, k)
    tb = x.shape[0] // k
    outs = fused_wavefront(params, list(x.split(tb)),
                           list(pattypes.split(tb)), bias_mult,
                           bidirectional, [x.device] * k, compute_dtype,
                           remat=True)
    ys = [torch.cat([o[i] for o in outs], dim=-1) for i in range(k)]
    return torch.cat(ys)[:T]


def _scan_acts_valid(x, pattypes, w_in, b, bias_mult: float,
                     compute_dtype: torch.dtype):
    """Input projection + bias as [T, D, B, 4, H] f32, and the validity
    mask [T, 1, B, 1]."""
    T, B, P = x.shape
    D, _, _, H = w_in.shape
    acts = torch.matmul(round_operand(x.reshape(T * B, P), compute_dtype),
                        round_operand(w_in.reshape(D, P, 4 * H),
                                      compute_dtype))
    acts = acts.view(D, T, B, 4, H).permute(1, 0, 2, 3, 4)
    acts = acts + bias_mult * b[None, :, None]
    valid = (pattypes != 0).float()[:, None, :, None]
    return acts, valid


def lstm_forward(params, x, pattypes, bias_mult: float, bidirectional: bool,
                 backend: str = "auto",
                 compute_dtype: torch.dtype = torch.float32,
                 remat_blocks: int = 0):
    """x: [T, B, P], pattypes: [T, B] int8 -> outputs [T, B, L] in x's dtype.

    L = H unidirectional, 2H bidirectional ([fw | bw] per frame). The
    kernel path needs each row's valid frames to be a prefix (trailing
    padding only), which every DataSet fraction is by construction; the
    scan path masks per step and takes any pattern. remat_blocks=K
    checkpoints the recurrence in K time blocks when autograd records (see
    the module docstring)."""
    w_in, w_rec, b, peep = (params["W_in"], params["W_rec"], params["b"],
                            params["peep"])
    T, B, P = x.shape
    D, _, _, H = w_in.shape
    if D != (2 if bidirectional else 1):
        raise ValueError(f"W_in has {D} directions; bidirectional="
                         f"{bidirectional}")
    need_grad = _needs_grad(x, w_in, w_rec, b, peep)
    kernels = kernel_route(backend, H, compute_dtype, need_grad)
    k = min(remat_blocks, T) if remat_blocks else 0
    if kernels and k > 1 and need_grad:
        ys = _remat_fused(params, x, pattypes, bias_mult, bidirectional, k,
                          compute_dtype)
        return ys.to(x.dtype)
    if kernels:
        lengths = (pattypes != 0).sum(dim=0, dtype=torch.int32)
        ys = lstm_scan_fused(x, w_in.reshape(D, P, 4 * H),
                             w_rec.reshape(D, H, 4 * H), peep,
                             b.reshape(D, 4 * H), lengths, float(bias_mult),
                             compute_dtype)
        return ys.to(x.dtype)

    acts, valid = _scan_acts_valid(x, pattypes, w_in, b, bias_mult,
                                   compute_dtype)
    if bidirectional:
        acts = torch.cat([acts[:, 0:1], acts.flip(0)[:, 1:2]], dim=1)
        mask = torch.cat([valid, valid.flip(0)], dim=1)
    else:
        mask = valid
    ys = _lstm_scan(acts, w_rec, peep, mask, compute_dtype,
                    remat_blocks=remat_blocks)  # [T, D, B, H]
    if bidirectional:
        ys = torch.cat([ys[:, 0], ys.flip(0)[:, 1]], dim=-1)
    else:
        ys = ys[:, 0]
    return ys.to(x.dtype)


def lstm_forward_streaming(params, x, pattypes, bias_mult: float, carry,
                           backend: str = "auto",
                           compute_dtype: torch.dtype = torch.float32):
    """One chunk of a UNIDIRECTIONAL layer from an explicit (h, c) state.

    x: [T, B, P] chunk; pattypes: [T, B]; carry: (h, c), [1, B, H] f32
    each, from the previous chunk (or Network.init_stream_state). Returns
    (y [T, B, H] in x's dtype, new carry). Chaining chunks gives
    lstm_forward on their concatenation: the streaming-serving primitive
    (Network.apply_streaming). A bidirectional layer cannot stream (its
    backward half consumes the future) and raises.

    backend "auto"/"pallas": the carry kernel (`_streaming_fused`); "scan":
    `_lstm_scan` with init/return_carry, which autograd differentiates
    (truncated BPTT over chunks). The kernel route is inference only."""
    w_in, w_rec, b, peep = (params["W_in"], params["W_rec"], params["b"],
                            params["peep"])
    if w_in.shape[0] != 1:
        raise ValueError("a bidirectional layer cannot stream (its backward "
                         "half consumes the future)")
    if kernel_route(backend, w_in.shape[-1], compute_dtype,
                    _needs_grad(x, w_in, w_rec, b, peep)):
        return _streaming_fused(params, x, pattypes, bias_mult, carry,
                                compute_dtype)
    acts, valid = _scan_acts_valid(x, pattypes, w_in, b, bias_mult,
                                   compute_dtype)
    ys, new_carry = _lstm_scan(acts, w_rec, peep, valid, compute_dtype,
                               init=carry, return_carry=True)
    return ys[:, 0].to(x.dtype), new_carry


def _streaming_fused(params, x, pattypes, bias_mult: float, carry,
                     compute_dtype: torch.dtype):
    """The streaming chunk on the carry kernel. A chunk carries PER-STEP
    validity, not a prefix: a sequence may end and another begin inside
    one chunk, and the state must be zeroed exactly at each NONE step, so
    the kernel gets the [B, T] step mask. carry_t is the chunk's length:
    the port pads nothing, so the final state is the last step's."""
    w_in, w_rec, b, peep = (params["W_in"], params["W_rec"], params["b"],
                            params["peep"])
    T, B, P = x.shape
    H = w_in.shape[-1]
    valid = pattypes != 0
    h0, c0 = carry
    ys, new_carry = lstm_scan_fused_carry(
        x, w_in.reshape(1, P, 4 * H), w_rec.reshape(1, H, 4 * H), peep,
        b.reshape(1, 4 * H), valid.sum(dim=0, dtype=torch.int32), h0, c0,
        float(bias_mult), True, compute_dtype, True, carry_t=T,
        step_mask=valid.t())
    return ys.to(x.dtype), new_carry
