"""The LSTM layer on the GPU: the wrappers of the Hopper kernels, their
plain twins, and the autograd Function that joins them.

Counterpart of lstm_rnn_tpu/ops/lstm_cell.py (`lstm_scan_fused` and
`lstm_scan_fused_carry`, each with its custom VJP). Six kernels, each
behind one wrapper with a launch count:

- `lstm_scan_fused` without gradients: the inference forward
  (`_fwd_kernel` save=False), csrc/lstm_fwd.cu, two launches per layer: the
  input projection into an f32 scratch buffer (csrc/gemm.cuh's GEMM), then
  the recurrence over both directions (see the note at the top of the
  source);
- `lstm_fwd_save`: the training forward (`_fwd_kernel` save=True), the
  same launches, with the residuals c and gates written by the recurrence;
- `lstm_bwd`: the BPTT (`_bwd_kernel`), csrc/lstm_bwd.cu, with the weight
  gradients and dx in hand-written GEMMs (csrc/gemm.cuh);
- `lstm_scan_fused_carry`: the forward from an initial state (h0, c0)
  with the final state out and an optional per-step mask (`_fwd_kernel`
  carry=True, save=False, with_mask), the carry variant of
  csrc/lstm_fwd.cu's recurrence: streaming serving's chunk and sequence
  parallelism's serving block;
- `lstm_fwd_save_carry`: the carry forward with residuals (`_fwd_kernel`
  carry=True, save=True; K6b forward), csrc/lstm_fwd.cu;
- `lstm_bwd_carry`: the carry BPTT (`_bwd_kernel` carry=True; K6b
  backward), csrc/lstm_bwd.cu, with dh0 and dc0 out.

`lstm_scan_fused` with gradients goes through `LstmScanFused`, whose
forward is `lstm_fwd_save` and whose backward is `lstm_bwd`;
`lstm_scan_fused_carry` with gradients (sequence parallelism's training,
prefix lengths only) through `LstmScanFusedCarry`, whose forward is
`lstm_fwd_save_carry` and whose backward is `lstm_bwd_carry`.

Shapes, as in the JAX package: x [T, B, P] in natural time order,
w_in [D, P, 4H], w_rec [D, H, 4H], peep [D, 3, H] f32, bias [D, 4H] f32,
lengths [B] int32 (each row's valid frames are a prefix). Gate order
[ni, ig, fg, og], peephole order [ig, fg, og]. Returns h [T, B, D*H] as
[fw | bw] per frame, in the storage dtype (bf16 in bfloat16 mode).

Precision. float32 mode: true f32 products and the CURRENNT forms of
logistic (saturating at +-EXP_LIMIT) and tanh (2*logistic(2x) - 1).
bfloat16 mode: x, W_in, W_rec and the h fed back into the recurrent
product are bf16; state and accumulation stay f32; sigma and tanh are the
plain functions (the JAX kernel's `_cell_acts(fast=True)`); h, the gates
and the BPTT deltas are stored in bf16.

--f32_matmul 3x (float32 mode, ops/gemm.py `F32_MATMUL_3X`): the
projection, dW_in, dW_rec and dx run in the engine's 3x instance, three
bf16 passes on the tensor cores (the JAX kernels' `_kdot(..., use3)` at
lstm_cell.py:227, :449, :475, :491). The recurrence's step product,
h . W_rec in the forward and da . W_rec^T (and the carry's dh0) in the
BPTT, stays exact FP32 on the SIMT pipes, where the JAX kernels split it
too (:242, :385, :436): it is latency-bound (2.1-2.4 us a step at H =
125), three bf16 passes there would be slower and less exact than one
f32 FMA, and exact f32 lies inside the 3x mode's error (about 2^-16 of
each product against f32's 2^-24). So does the carry BPTT's dW_rec edge
term (h0^T . da at the scan edge, edge_grad_kernel). The wrappers read
the switch at launch; the twins take it as `x3` and split the same
products (ops/gemm.py `matmul3`).

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs its plain twin (`lstm_scan_reference`,
`lstm_scan_bwd_reference`, `lstm_scan_carry_reference`,
`lstm_scan_carry_bwd_reference`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from lstm_rnn_tpu_torch.models.feedforward import round_operand
from lstm_rnn_tpu_torch.ops.activations import logistic, tanh2
from lstm_rnn_tpu_torch.ops.gemm import count_launches, product, use3

COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def storage_dtype(compute_dtype: torch.dtype) -> torch.dtype:
    """bf16 in bf16 mode, float64 in the scan route's float64 mode (CPU
    only: no kernel takes it), else float32."""
    if compute_dtype in (torch.bfloat16, torch.float64):
        return compute_dtype
    return torch.float32


def lstm_cell_step(a, c, peep, fast: bool, gclip=None):
    """CURRENNT cell (ComputeBlockOutputFn, LstmLayer.cu:47-138) from
    complete gate preactivations a [D, B, 4, H] and cell state c [D, B, H];
    peep [D, 3, H]. fast=True takes the plain sigma/tanh of bf16 mode.

    gclip (autograd through the scan path): wrapped around each complete
    preactivation, with the og peephole split so that autograd gives the
    clipped og delta to a_og and p_og but the UNCLIPPED one to the cell
    state (LstmLayer.cu:246-250 vs :284), as the JAX package's
    lstm_cell_step does; the forward values are unchanged.
    Returns (h_new, c_new, (ni, ig, fg, og)), unmasked."""
    sig, tanh = (torch.sigmoid, torch.tanh) if fast else (logistic, tanh2)
    clip = gclip or (lambda v: v)
    ni = tanh(clip(a[:, :, 0]))
    ig = sig(clip(a[:, :, 1] + c * peep[:, None, 0]))
    fg = sig(clip(a[:, :, 2] + c * peep[:, None, 1]))
    c_new = ni * ig + fg * c
    p_og = peep[:, None, 2]  # peephole from the NEW cell state
    if gclip is None:
        og = sig(a[:, :, 3] + c_new * p_og)
    else:
        c_sg = c_new.detach()
        og = sig(gclip(a[:, :, 3] + c_sg * p_og)
                 + (c_new - c_sg) * p_og.detach())
    return tanh(c_new) * og, c_new, (ni, ig, fg, og)


def _validity(lengths, T: int, device):
    """[T, B] float: 1 where t < lengths[b]."""
    return (torch.arange(T, device=device)[:, None]
            < lengths.to(device)[None, :]).float()


def _twin_loop(x, w_in, w_rec, peep, bias, bias_mult, compute_dtype,
               valid, h, c, desc, save=False, cap=None, x3=False):
    """The forward kernels' time loop, shared by their twins. valid [T, B]
    float (1 valid, 0 not); h, c [D, B, H] f32 starting state (the product
    reads h rounded to the compute dtype, as the kernel does); desc[d]:
    direction d walks time descending over the natural-order arrays;
    cap[d]: the step s whose state is direction d's final one (returned as
    (hf, cf), hf before storage rounding). Returns (out, c_res, g_res, hf,
    cf), the residuals None unless save. x3: the projection as three bf16
    passes (the recurrence's product stays exact)."""
    T, B, P = x.shape
    D, _, G = w_in.shape
    H = G // 4
    fast = compute_dtype == torch.bfloat16
    sdtype = storage_dtype(compute_dtype)
    a = product(round_operand(x.reshape(T * B, P), compute_dtype),
                round_operand(w_in, compute_dtype), x3)
    a = (a + bias_mult * bias[:, None]).view(D, T, B, G)
    w = round_operand(w_rec, compute_dtype)
    out = torch.empty(T, B, D * H, dtype=sdtype, device=x.device)
    c_res = g_res = hf = cf = None
    if save:
        c_res = torch.empty(D, T, B, H, device=x.device)
        g_res = torch.empty(D, T, B, G, dtype=sdtype, device=x.device)
    if cap is not None:
        hf = torch.zeros(D, B, H, device=x.device)
        cf = torch.zeros(D, B, H, device=x.device)
    for s in range(T):
        ts = [T - 1 - s if desc[d] else s for d in range(D)]
        g = torch.stack([a[d, t] for d, t in enumerate(ts)])
        g = g + torch.bmm(round_operand(h, compute_dtype), w)
        h_new, c_new, gates = lstm_cell_step(g.view(D, B, 4, H), c, peep,
                                             fast)
        m = torch.stack([valid[t] for t in ts])[..., None]
        h_m = h_new * m
        c = c_new * m
        h = h_m.to(sdtype)
        if save:
            gm = (torch.cat(gates, dim=-1) * m).to(sdtype)
        for d, t in enumerate(ts):
            out[t, :, d * H:(d + 1) * H] = h[d]
            if save:
                c_res[d, t] = c[d]
                g_res[d, t] = gm[d]
            if cap is not None and s == cap[d]:
                hf[d], cf[d] = h_m[d], c[d]
        h = h.float()
    return out, c_res, g_res, hf, cf


def lstm_scan_reference(x, w_in, w_rec, peep, bias, lengths,
                        bias_mult: float = 1.0,
                        compute_dtype: torch.dtype = torch.float32,
                        save: bool = False, x3: bool = False):
    """The forward kernels' plain-torch twin: a Python time loop over the
    same math, rounding at the same points. Direction 1 walks time
    descending over the natural-order arrays, as the kernel does. x3: the
    --f32_matmul 3x twin (the projection as three bf16 passes).

    save=True also returns the training residuals, as lstm_fwd_save:
    (h, c [D, T, B, H] f32, gates [D, T, B, 4H] in the storage dtype),
    both zero at padding."""
    T, B, _ = x.shape
    D, _, G = w_in.shape
    zero = torch.zeros(D, B, G // 4, device=x.device)
    out, c_res, g_res, _, _ = _twin_loop(
        x, w_in, w_rec, peep, bias, bias_mult, compute_dtype,
        _validity(lengths, T, x.device), zero, zero, (False, True)[:D], save,
        x3=x3)
    if save:
        return out, c_res, g_res
    return out


def lstm_scan_carry_reference(x, w_in, w_rec, peep, bias, lengths, h0, c0,
                              bias_mult: float = 1.0,
                              compute_dtype: torch.dtype = torch.float32,
                              carry_t=None, dir_offset: int = 0,
                              step_mask=None, save: bool = False,
                              x3: bool = False):
    """The carry kernels' plain-torch twin (the JAX package's `_fwd_kernel`
    with carry=True, save=False and an optional step mask): the time loop
    of lstm_scan_reference from (h0, c0) [D, B, H] f32, with validity from
    step_mask [B, T] (nonzero = valid, any pattern) or, without one, from
    lengths. Returns (h [T, B, D*H] in the storage dtype, (hf, cf)
    [D, B, H] f32): the masked state of an ascending direction at step
    carry_t - 1 (default T) and of a descending one (d + dir_offset > 0)
    at t = 0, hf before storage rounding. Arguments as
    lstm_scan_fused_carry, which checks them.

    save=True is the twin of lstm_fwd_save_carry (carry=True, save=True,
    the K6b forward): it returns (h, c, gates, (hf, cf)), the residuals as
    lstm_scan_reference(save=True) returns them."""
    T = x.shape[0]
    D = w_in.shape[0]
    carry_t = T if carry_t is None else carry_t
    valid = (_validity(lengths, T, x.device) if step_mask is None
             else (step_mask != 0).float().t().to(x.device))
    desc = [d + dir_offset != 0 for d in range(D)]
    out, c_res, g_res, hf, cf = _twin_loop(
        x, w_in, w_rec, peep, bias, bias_mult, compute_dtype, valid,
        h0.float(), c0.float(), desc, save,
        cap=[T - 1 if desc[d] else carry_t - 1 for d in range(D)], x3=x3)
    if save:
        return out, c_res, g_res, (hf, cf)
    return out, (hf, cf)


def _scan_prev(full, asc: bool, edge):
    """The scan-previous rows of full [T, B, ...] (t-1 for a scan that
    ascends time, t+1 for one that descends); at the scan edge, `edge`
    [B, ...]."""
    if asc:
        return torch.cat([edge[None], full[:-1]])
    return torch.cat([full[1:], edge[None]])


def lstm_scan_bwd_reference(x, w_in, w_rec, peep, lengths, h, c, gates, dh,
                            bias_mult: float = 1.0, clip: bool = True,
                            compute_dtype: torch.dtype = torch.float32,
                            need_dx: bool = True, x3: bool = False):
    """The BPTT kernel's plain-torch twin: a Python loop over the math of
    the JAX package's `_bwd_kernel` (lstm_rnn_tpu/ops/lstm_cell.py:346-494),
    rounding at the same points, then the weight gradients as plain
    products. h, c, gates are lstm_fwd_save's outputs; dh [T, B, D*H].
    Returns (dx [T, B, P] f32 or None, dW_in [D, P, 4H], dW_rec [D, H, 4H],
    dpeep [D, 3, H], dbias [D, 4H]), all f32. x3: dW_in, dW_rec and dx as
    three bf16 passes (the step product stays exact)."""
    return _bwd_twin(x, w_in, w_rec, peep, lengths, h, c, gates, dh,
                     bias_mult, clip, compute_dtype, need_dx, x3=x3)


def lstm_scan_carry_bwd_reference(x, w_in, w_rec, peep, lengths, h, c,
                                  gates, h0, c0, dh, dhf, dcf,
                                  bias_mult: float = 1.0, clip: bool = True,
                                  compute_dtype: torch.dtype = torch.float32,
                                  need_dx: bool = True, carry_t=None,
                                  dir_offset: int = 0, x3: bool = False):
    """The carry BPTT kernel's plain-torch twin (the JAX package's
    `_bwd_kernel` with carry=True, lstm_cell.py:304-311, :346-440,
    :471-479): lstm_scan_bwd_reference with the carry's edges. h, c, gates
    are lstm_fwd_save_carry's residuals of the forward from (h0, c0)
    [D, B, H] f32; dhf, dcf [D, B, H] f32 the cotangents of its final state.
    Direction d walks descending when d + dir_offset > 0. At the scan edge
    c_prev is c0 (and its fg delta counts) and h_prev, for dW_rec, is h0
    rounded to the compute dtype; dhf joins e and dcf joins the cell-state
    error at the capture step (carry_t - 1 ascending, t = 0 descending).
    Returns lstm_scan_bwd_reference's five outputs and then (dh0, dc0)
    [D, B, H] f32: dh0 = round(da) . W_rec^T and dc0 = fg cs_err + p_ig
    da[ig] + p_fg da[fg] after the last BPTT step. x3: as in
    lstm_scan_bwd_reference, with dW_rec's edge term h0^T . da exact, as
    the kernel adds it."""
    carry_t = x.shape[0] if carry_t is None else carry_t
    return _bwd_twin(x, w_in, w_rec, peep, lengths, h, c, gates, dh,
                     bias_mult, clip, compute_dtype, need_dx,
                     (h0, c0, dhf, dcf, carry_t, dir_offset), x3=x3)


def _bwd_twin(x, w_in, w_rec, peep, lengths, h, c, gates, dh, bias_mult,
              clip, compute_dtype, need_dx, carry=None, x3=False):
    """The BPTT twins' shared loop; carry = (h0, c0, dhf, dcf, carry_t,
    dir_offset) or None (zero state, no final-state cotangents)."""
    T, B, P = x.shape
    D, _, G = w_in.shape
    H = G // 4
    fast = compute_dtype == torch.bfloat16
    sdtype = storage_dtype(compute_dtype)
    tanh = torch.tanh if fast else tanh2
    dev = x.device
    w_t = round_operand(w_rec, compute_dtype).transpose(1, 2)  # [D, 4H, H]
    valid = _validity(lengths, T, dev)
    gf = gates.float()
    dhf = dh.to(sdtype).float().reshape(T, B, D, H)
    p_ig, p_fg, p_og = (peep[:, None, i] for i in range(3))
    da_next = torch.zeros(D, B, G, device=dev)
    cse = torch.zeros(D, B, H, device=dev)
    fgn = torch.zeros(D, B, H, device=dev)
    da = torch.empty(D, T, B, G, dtype=sdtype, device=dev)
    if carry is None:
        dir_offset, edge_c = 0, torch.zeros(D, B, H, device=dev)
    else:
        h0, edge_c, dh_f, dc_f, carry_t, dir_offset = carry
    asc = [d + dir_offset == 0 for d in range(D)]
    for s in range(T):
        # BPTT walks each scan in reverse
        ts = [T - 1 - s if asc[d] else s for d in range(D)]
        e = torch.stack([dhf[t, :, d] for d, t in enumerate(ts)]) + \
            torch.bmm(round_operand(da_next, compute_dtype), w_t)
        dcf_term = 0.0
        if carry is not None:
            # the final (h, c) are the capture step's through an identity
            cap = torch.tensor([float(t == (carry_t - 1 if asc[d] else 0))
                                for d, t in enumerate(ts)],
                               device=dev)[:, None, None]
            e = e + dh_f * cap
            dcf_term = dc_f * cap
        ni, ig, fg, og = torch.stack(
            [gf[d, t] for d, t in enumerate(ts)]).split(H, dim=-1)
        cc = torch.stack([c[d, t] for d, t in enumerate(ts)])
        edge = [t <= 0 if asc[d] else t >= T - 1 for d, t in enumerate(ts)]
        c_prev = torch.stack([
            edge_c[d] if edge[d] else c[d, t - 1 if asc[d] else t + 1]
            for d, t in enumerate(ts)])
        # with a carry the scan edge has a previous cell state, c0
        has_prev = torch.tensor(
            [0.0 if e_ and carry is None else 1.0 for e_ in edge],
            device=dev)[:, None, None]
        m = torch.stack([valid[t] for t in ts])[..., None]
        tanh_c = tanh(cc)
        og_delta = og * (1.0 - og) * tanh_c * e
        # the UNCLIPPED og delta feeds the cell-state error (the clipped
        # ig/fg deltas of the step before feed it through the peepholes)
        cs_err = (og * (1.0 - tanh_c * tanh_c) * e + p_og * og_delta
                  + fgn * cse + p_ig * da_next[..., H:2 * H]
                  + p_fg * da_next[..., 2 * H:3 * H]) + dcf_term
        deltas = [ig * (1.0 - ni * ni) * cs_err,
                  ig * (1.0 - ig) * ni * cs_err,
                  fg * (1.0 - fg) * c_prev * cs_err * has_prev,
                  og_delta]
        if clip:
            deltas = [torch.clamp(v, -1.0, 1.0) for v in deltas]
        da_next = torch.cat(deltas, dim=-1) * m
        cse = cs_err * m
        fgn = fg * m
        for d, t in enumerate(ts):
            da[d, t] = da_next[d]
    daf = da.float()  # the stored deltas feed every product and sum
    da2 = daf.view(D, T * B, G)
    xr = round_operand(x, compute_dtype).reshape(T * B, P)
    dw_in = product(xr, da2, x3,
                    lambda u, v: torch.einsum("mp,dmg->dpg", u, v))
    hs = h.float().view(T, B, D, H)
    # the edge row's h_prev: h0 as the product reads it (zero without one)
    edge_h = (torch.zeros(D, B, H, device=dev) if carry is None
              else round_operand(h0.float(), compute_dtype))

    def h_prev(edge):
        return torch.stack([_scan_prev(hs[:, :, d], asc[d], edge[d])
                            for d in range(D)]).reshape(D, T * B, H)

    def rec(u, v):
        return torch.einsum("dmh,dmg->dhg", u, v)

    if x3:
        # the product reads zero at the edge rows; their term h0^T . da is
        # added in exact f32 (edge_grad_kernel)
        inner = h_prev(torch.zeros_like(edge_h))
        dw_rec = product(inner, da2, True, rec) + rec(h_prev(edge_h) - inner,
                                                      da2)
    else:
        dw_rec = rec(h_prev(edge_h), da2)
    c_prev = torch.stack([_scan_prev(c[d], asc[d], edge_c[d])
                          for d in range(D)])
    dpeep = torch.stack([(c_prev * daf[..., H:2 * H]).sum((1, 2)),
                         (c_prev * daf[..., 2 * H:3 * H]).sum((1, 2)),
                         (c * daf[..., 3 * H:]).sum((1, 2))], dim=1)
    dbias = bias_mult * daf.sum((1, 2))
    dx = None
    if need_dx:
        # one plane per direction in the storage dtype, summed in f32
        planes = product(da2, round_operand(w_in, compute_dtype), x3,
                         lambda u, v: torch.einsum("dmg,dpg->dmp", u, v))
        dx = planes.to(sdtype).float().sum(0).view(T, B, P)
    if carry is None:
        return dx, dw_in, dw_rec, dpeep, dbias
    # after the last BPTT step: the recurrence's terms at the virtual step
    # before the scan are the initial state's gradients
    dh0 = torch.bmm(round_operand(da_next, compute_dtype), w_t)
    dc0 = (fgn * cse + p_ig * da_next[..., H:2 * H]
           + p_fg * da_next[..., 2 * H:3 * H])
    return dx, dw_in, dw_rec, dpeep, dbias, dh0, dc0


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


def _check_compute_dtype(compute_dtype):
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be float32 or bfloat16, "
                         f"got {compute_dtype}")


def _on_cuda(x, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one (the twin runs)."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or CPU, not {x.device}")
    return True


def lstm_scan_fused(x, w_in, w_rec, peep, bias, lengths,
                    bias_mult: float = 1.0,
                    compute_dtype: torch.dtype = torch.float32,
                    clip: bool = True):
    """One (B)LSTM layer's forward: the CUDA kernels on a CUDA tensor, the
    twins on a CPU tensor. See the module docstring for shapes.

    When autograd records (a gradient is wanted for x or a weight), the
    layer goes through LstmScanFused: the training forward (lstm_fwd_save)
    now and the BPTT kernel (lstm_bwd) on the way back, with the deltas
    clipped to +-1 when `clip`. Otherwise (inference mode, no_grad) it runs
    the inference forward, which writes no residuals."""
    _check_compute_dtype(compute_dtype)
    args = (x, w_in, w_rec, peep, bias, lengths)
    _check_shapes(*args)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args[:5]):
        return LstmScanFused.apply(x, w_in, w_rec, peep, bias, lengths,
                                   float(bias_mult), bool(clip),
                                   compute_dtype)
    x3 = use3(compute_dtype)
    if not _on_cuda(x, "lstm_scan_fused"):
        return lstm_scan_reference(*args, bias_mult, compute_dtype, x3=x3)
    _check_cuda_operands(x=x, w_in=w_in, w_rec=w_rec, peep=peep, bias=bias,
                         lengths=lengths)
    a = _launch_proj(x.to(compute_dtype), w_in.to(compute_dtype), bias,
                     bias_mult, x3)
    out = _launch_rec(a, w_rec.to(compute_dtype), peep, lengths)
    lstm_scan_fused.launches += 1
    return out


# Kernel launches on the main path (chip_smoke.py resets and reads them).
lstm_scan_fused.launches = 0


def lstm_fwd_save(x, w_in, w_rec, peep, bias, lengths,
                  bias_mult: float = 1.0,
                  compute_dtype: torch.dtype = torch.float32):
    """The training forward: (h, c, gates) as lstm_scan_reference(save=True)
    returns them; the CUDA kernels on a CUDA tensor, the twin on a CPU
    one."""
    _check_compute_dtype(compute_dtype)
    args = (x, w_in, w_rec, peep, bias, lengths)
    _check_shapes(*args)
    x3 = use3(compute_dtype)
    if not _on_cuda(x, "lstm_fwd_save"):
        return lstm_scan_reference(*args, bias_mult, compute_dtype,
                                   save=True, x3=x3)
    _check_cuda_operands(x=x, w_in=w_in, w_rec=w_rec, peep=peep, bias=bias,
                         lengths=lengths)
    a = _launch_proj(x.to(compute_dtype), w_in.to(compute_dtype), bias,
                     bias_mult, x3)
    out = _launch_rec(a, w_rec.to(compute_dtype), peep, lengths, save=True)
    lstm_fwd_save.launches += 1
    return out


lstm_fwd_save.launches = 0


def lstm_bwd(x, w_in, w_rec, peep, lengths, h, c, gates, dh,
             bias_mult: float = 1.0, clip: bool = True,
             compute_dtype: torch.dtype = torch.float32,
             need_dx: bool = True):
    """The BPTT of one layer from lstm_fwd_save's residuals: (dx or None,
    dW_in, dW_rec, dpeep, dbias) as lstm_scan_bwd_reference returns them;
    the CUDA kernels on a CUDA tensor, the twin on a CPU one."""
    _check_compute_dtype(compute_dtype)
    T, B, _ = x.shape
    D, _, G = w_in.shape
    sdtype = storage_dtype(compute_dtype)
    want = {"h": ((T, B, D * G // 4), h), "dh": ((T, B, D * G // 4), dh),
            "c": ((D, T, B, G // 4), c), "gates": ((D, T, B, G), gates)}
    for name, (shape, t) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
    x3 = use3(compute_dtype)
    if not _on_cuda(x, "lstm_bwd"):
        return lstm_scan_bwd_reference(x, w_in, w_rec, peep, lengths, h, c,
                                       gates, dh, bias_mult, clip,
                                       compute_dtype, need_dx, x3=x3)
    _check_cuda_operands(x=x, w_in=w_in, w_rec=w_rec, peep=peep,
                         lengths=lengths, h=h, c=c, gates=gates)
    if h.dtype != sdtype or gates.dtype != sdtype:
        raise TypeError(f"h and gates must be {sdtype} (lstm_fwd_save's "
                        f"residuals), got {h.dtype} and {gates.dtype}")
    out = _launch_bwd(x, w_in, w_rec, peep, lengths, h, c, gates,
                      dh.to(sdtype).contiguous(), bias_mult, clip,
                      compute_dtype, need_dx, x3=x3)
    lstm_bwd.launches += 1
    return out


lstm_bwd.launches = 0


def _check_carry(x, w_in, h0, c0, carry_t, dir_offset, step_mask):
    """The carry operands against x [T, B, P] and w_in [D, P, 4H], as the
    JAX package's _fwd_impl checks them."""
    T, B, _ = x.shape
    D, _, G = w_in.shape
    for name, t, shape in (("h0", h0, (D, B, G // 4)),
                           ("c0", c0, (D, B, G // 4)),
                           ("step_mask", step_mask, (B, T))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape} for x {tuple(x.shape)}")
    if dir_offset not in (0, 1) or (D == 2 and dir_offset):
        raise ValueError(f"dir_offset must be 0, or 1 with D == 1; got "
                         f"{dir_offset} with D == {D}")
    if not 1 <= carry_t <= T:
        raise ValueError(f"carry_t must be in [1, T={T}], got {carry_t}")
    if (D == 2 or dir_offset == 1) and carry_t != T:
        # a descending direction enters at t = T-1: trailing padding would
        # sit at its entry and zero the incoming carry
        raise ValueError(
            "descending-direction carries (D == 2 or dir_offset == 1) "
            f"require carry_t == T (got carry_t={carry_t}, T={T}): pad the "
            "chunk before chaining, or chain ascending directions only")


def lstm_scan_fused_carry(x, w_in, w_rec, peep, bias, lengths, h0, c0,
                          bias_mult: float = 1.0, clip: bool = True,
                          compute_dtype: torch.dtype = torch.float32,
                          need_dx: bool = True, carry_t=None,
                          dir_offset: int = 0, step_mask=None):
    """One LSTM layer's forward from an explicit initial state, emitting
    the final state: streaming serving's chunk (the JAX package's
    `lstm_scan_fused_carry`, whose signature it keeps). The carry kernel
    on a CUDA tensor, `lstm_scan_carry_reference` on a CPU one.

    h0, c0 [D, B, H] f32: the state each direction enters with (d = 0 at
    t = 0, a descending direction at t = T-1). Returns (h [T, B, D*H] in
    the storage dtype, (hf, cf) [D, B, H] f32): the masked state of an
    ascending direction at step carry_t - 1 (default T) and of a
    descending one at t = 0; chaining calls through (hf, cf) equals one
    call on the concatenated chunks. dir_offset=1 (D = 1) runs the single
    direction descending; descending directions need carry_t == T.
    step_mask [B, T] (nonzero = valid, any pattern) replaces the prefix
    validity of `lengths`, which it then ignores.

    When autograd records (a gradient is wanted for x, a weight, h0 or
    c0), the layer goes through LstmScanFusedCarry: the carry forward with
    residuals (lstm_fwd_save_carry) now and the carry BPTT (lstm_bwd_carry)
    on the way back, which gives h0 and c0 their gradients (sequence
    parallelism's training chains blocks through them). With a step mask
    it raises NotImplementedError instead, as the JAX package does: the
    backward takes prefix lengths only. clip and need_dx only matter to
    the backward; dx is computed when x needs a gradient and need_dx is
    set."""
    _check_compute_dtype(compute_dtype)
    args = (x, w_in, w_rec, peep, bias, lengths)
    _check_shapes(*args)
    carry_t = x.shape[0] if carry_t is None else int(carry_t)
    _check_carry(x, w_in, h0, c0, carry_t, dir_offset, step_mask)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w_in, w_rec, peep, bias, h0, c0)):
        if step_mask is not None:
            raise NotImplementedError(
                "lstm_scan_fused_carry(step_mask=...) is inference-only; "
                "training paths must express validity as prefix lengths")
        h, hf, cf = LstmScanFusedCarry.apply(
            x, w_in, w_rec, peep, bias, lengths, h0, c0, float(bias_mult),
            bool(clip), compute_dtype, bool(need_dx), carry_t, dir_offset)
        return h, (hf, cf)
    x3 = use3(compute_dtype)
    if not _on_cuda(x, "lstm_scan_fused_carry"):
        return lstm_scan_carry_reference(*args, h0, c0, bias_mult,
                                         compute_dtype, carry_t, dir_offset,
                                         step_mask, x3=x3)
    _check_cuda_operands(x=x, w_in=w_in, w_rec=w_rec, peep=peep, bias=bias,
                         lengths=lengths, h0=h0, c0=c0)
    mask = None
    if step_mask is not None:
        if step_mask.device != x.device:
            raise ValueError(f"step_mask is on {step_mask.device}, x on "
                             f"{x.device}")
        mask = (step_mask != 0).to(torch.uint8).contiguous()
    a = _launch_proj(x.to(compute_dtype), w_in.to(compute_dtype), bias,
                     bias_mult, x3)
    out = _launch_rec_carry(a, w_rec.to(compute_dtype), peep, lengths, mask,
                            h0, c0, carry_t, dir_offset)
    lstm_scan_fused_carry.launches += 1
    return out


lstm_scan_fused_carry.launches = 0


def lstm_fwd_save_carry(x, w_in, w_rec, peep, bias, lengths, h0, c0,
                        bias_mult: float = 1.0,
                        compute_dtype: torch.dtype = torch.float32,
                        carry_t=None, dir_offset: int = 0):
    """The carry forward with residuals (the JAX package's `_fwd_kernel`
    carry=True, save=True: `_fused_carry_fwd`): (h, c, gates, (hf, cf)) as
    lstm_scan_carry_reference(save=True) returns them, validity from prefix
    lengths; the CUDA kernels on a CUDA tensor, the twin on a CPU one."""
    _check_compute_dtype(compute_dtype)
    args = (x, w_in, w_rec, peep, bias, lengths)
    _check_shapes(*args)
    carry_t = x.shape[0] if carry_t is None else int(carry_t)
    _check_carry(x, w_in, h0, c0, carry_t, dir_offset, None)
    x3 = use3(compute_dtype)
    if not _on_cuda(x, "lstm_fwd_save_carry"):
        return lstm_scan_carry_reference(*args, h0, c0, bias_mult,
                                          compute_dtype, carry_t, dir_offset,
                                          save=True, x3=x3)
    _check_cuda_operands(x=x, w_in=w_in, w_rec=w_rec, peep=peep, bias=bias,
                         lengths=lengths, h0=h0, c0=c0)
    a = _launch_proj(x.to(compute_dtype), w_in.to(compute_dtype), bias,
                     bias_mult, x3)
    out = _launch_rec_carry(a, w_rec.to(compute_dtype), peep, lengths, None,
                            h0, c0, carry_t, dir_offset, save=True)
    lstm_fwd_save_carry.launches += 1
    return out


lstm_fwd_save_carry.launches = 0


def lstm_bwd_carry(x, w_in, w_rec, peep, lengths, h, c, gates, h0, c0, dh,
                   dhf, dcf, bias_mult: float = 1.0, clip: bool = True,
                   compute_dtype: torch.dtype = torch.float32,
                   need_dx: bool = True, carry_t=None, dir_offset: int = 0):
    """The carry BPTT of one layer (the JAX package's `_bwd_kernel`
    carry=True: `_fused_carry_bwd`) from lstm_fwd_save_carry's residuals of
    the forward from (h0, c0), with the cotangents dh of h and (dhf, dcf)
    of the final state: (dx or None, dW_in, dW_rec, dpeep, dbias, dh0, dc0)
    as lstm_scan_carry_bwd_reference returns them; the CUDA kernels on a
    CUDA tensor, the twin on a CPU one."""
    _check_compute_dtype(compute_dtype)
    T, B, _ = x.shape
    D, _, G = w_in.shape
    H = G // 4
    sdtype = storage_dtype(compute_dtype)
    carry_t = T if carry_t is None else int(carry_t)
    _check_carry(x, w_in, h0, c0, carry_t, dir_offset, None)
    want = {"h": ((T, B, D * H), h), "dh": ((T, B, D * H), dh),
            "c": ((D, T, B, H), c), "gates": ((D, T, B, G), gates),
            "dhf": ((D, B, H), dhf), "dcf": ((D, B, H), dcf)}
    for name, (shape, t) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
    x3 = use3(compute_dtype)
    if not _on_cuda(x, "lstm_bwd_carry"):
        return lstm_scan_carry_bwd_reference(
            x, w_in, w_rec, peep, lengths, h, c, gates, h0.float(),
            c0.float(), dh, dhf.float(), dcf.float(), bias_mult, clip,
            compute_dtype, need_dx, carry_t, dir_offset, x3=x3)
    _check_cuda_operands(x=x, w_in=w_in, w_rec=w_rec, peep=peep,
                         lengths=lengths, h=h, c=c, gates=gates, h0=h0, c0=c0,
                         dhf=dhf, dcf=dcf)
    if h.dtype != sdtype or gates.dtype != sdtype:
        raise TypeError(f"h and gates must be {sdtype} (lstm_fwd_save_carry's "
                        f"residuals), got {h.dtype} and {gates.dtype}")
    out = _launch_bwd(x, w_in, w_rec, peep, lengths, h, c, gates,
                      dh.to(sdtype).contiguous(), bias_mult, clip,
                      compute_dtype, need_dx,
                      (h0, c0, dhf, dcf, carry_t, dir_offset), x3=x3)
    lstm_bwd_carry.launches += 1
    return out


lstm_bwd_carry.launches = 0


class LstmScanFused(torch.autograd.Function):
    """lstm_scan_fused with gradients (the JAX package's custom VJP):
    forward = lstm_fwd_save, backward = lstm_bwd. need_dx follows
    needs_input_grad: the first hidden layer's input is the data, whose
    gradient nobody wants, so its dx product is skipped."""

    @staticmethod
    def forward(ctx, x, w_in, w_rec, peep, bias, lengths, bias_mult, clip,
                compute_dtype):
        h, c, gates = lstm_fwd_save(x, w_in, w_rec, peep, bias, lengths,
                                    bias_mult, compute_dtype)
        ctx.save_for_backward(x, w_in, w_rec, peep, lengths, h, c, gates)
        ctx.cfg = (bias_mult, clip, compute_dtype)
        return h

    @staticmethod
    def backward(ctx, dh):
        x, w_in, w_rec, peep, lengths, h, c, gates = ctx.saved_tensors
        need_dx = ctx.needs_input_grad[0]
        dx, dw_in, dw_rec, dpeep, dbias = lstm_bwd(
            x, w_in, w_rec, peep, lengths, h, c, gates, dh, *ctx.cfg,
            need_dx=need_dx)
        return (dx.to(x.dtype) if need_dx else None, dw_in, dw_rec, dpeep,
                dbias, None, None, None, None)


class LstmScanFusedCarry(torch.autograd.Function):
    """lstm_scan_fused_carry with gradients (the JAX package's custom VJP
    of `lstm_scan_fused_carry`): forward = lstm_fwd_save_carry, backward =
    lstm_bwd_carry. Outputs (h, hf, cf); autograd hands an unused output's
    cotangent in as zeros. need_dx follows needs_input_grad, as in
    LstmScanFused."""

    @staticmethod
    def forward(ctx, x, w_in, w_rec, peep, bias, lengths, h0, c0, bias_mult,
                clip, compute_dtype, need_dx, carry_t, dir_offset):
        h, c, gates, (hf, cf) = lstm_fwd_save_carry(
            x, w_in, w_rec, peep, bias, lengths, h0, c0, bias_mult,
            compute_dtype, carry_t, dir_offset)
        ctx.save_for_backward(x, w_in, w_rec, peep, lengths, h, c, gates,
                              h0, c0)
        ctx.cfg = (bias_mult, clip, compute_dtype)
        ctx.carry = (need_dx, carry_t, dir_offset)
        return h, hf, cf

    @staticmethod
    def backward(ctx, dh, dhf, dcf):
        x, w_in, w_rec, peep, lengths, h, c, gates, h0, c0 = \
            ctx.saved_tensors
        need_dx, carry_t, dir_offset = ctx.carry
        need_dx = need_dx and ctx.needs_input_grad[0]
        dx, dw_in, dw_rec, dpeep, dbias, dh0, dc0 = lstm_bwd_carry(
            x, w_in, w_rec, peep, lengths, h, c, gates, h0, c0, dh,
            dhf.float().contiguous(), dcf.float().contiguous(), *ctx.cfg,
            need_dx=need_dx, carry_t=carry_t, dir_offset=dir_offset)
        return (dx.to(x.dtype) if need_dx else None, dw_in, dw_rec, dpeep,
                dbias, None, dh0.to(h0.dtype), dc0.to(c0.dtype), None, None,
                None, None, None, None)


# The recurrences' cluster plan, as csrc/recurrence.cuh's rec_plan picks
# it (a CPU test reads these constants from that file): one cluster of n
# CTAs per direction and group of REC_ROWS rows, CTA i owning a slice of
# the H cells and the part of W_rec they need, in shared memory when it
# fits beside the two parity buffers of the exchanged operand, else read
# from L2 every step.
REC_ROWS = 8
LANES_PER_CELL = 8
CELLS_PER_WARP = 32 // LANES_PER_CELL
CELLS_PER_CTA = 16
MAX_CLUSTER = 16
REC_MAX_THREADS = 512
QUAD_FLOATS = 36
# the shared memory a block may opt into on an H100
SMEM_OPTIN = 232_448


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def recurrence_plan(H: int, compute_dtype: torch.dtype, kind: str) -> dict:
    """The cluster plan of the forward (kind "fwd": rec_kernel and its
    carry variants) or the BPTT ("bwd") recurrence at width H: n (CTAs of
    a cluster), slices [(start, count)] of the cells per CTA, threads a
    CTA, smem (dynamic shared memory a CTA, bytes), w_on_chip (W_rec's
    slice in shared memory, else from L2), state (bytes of the parity
    buffers, on chip on every route) and w (bytes of the W slice). ok is
    False for a width no CTA takes (the state does not fit or too many
    threads): the kernels refuse it."""
    if kind not in ("fwd", "bwd"):
        raise ValueError(f"kind must be 'fwd' or 'bwd', got {kind!r}")
    wbytes = 2 if compute_dtype == torch.bfloat16 else 4
    n = min(MAX_CLUSTER, max(1, -(-H // CELLS_PER_CTA)))
    cmax = -(-H // n)
    cpad = _round_up(cmax, CELLS_PER_WARP)
    if kind == "bwd":  # W's rows held in f32 in both modes
        kp = ws = _round_up(4 * H, 4 * 32)
        w = cpad * ws * 4
    else:
        kp = _round_up(H, 2 * LANES_PER_CELL)
        ws = _round_up(H, 16) + 8
        w = cpad * ws * 4 * wbytes
    state = 2 * (kp // 4) * QUAD_FLOATS * 4
    base, extra = divmod(H, n)
    slices = [(i * base + min(i, extra), base + (i < extra))
              for i in range(n)]
    threads = cpad * LANES_PER_CELL
    on_chip = state + w <= SMEM_OPTIN
    return dict(n=n, slices=slices, threads=threads, state=state, w=w,
                w_on_chip=on_chip, smem=state + w if on_chip else state,
                ok=state <= SMEM_OPTIN and threads <= REC_MAX_THREADS)


def recurrence_fits(H: int, compute_dtype: torch.dtype,
                    need_grad: bool) -> bool:
    """True when the recurrence kernels take width H: the forward's plan
    is ok and, when autograd records (need_grad), the BPTT's too (the
    forward and its BPTT are one autograd Function: a layer that trains
    takes both kernels or neither). Decided from the plan alone, the same
    on the CPU as on the card."""
    return (recurrence_plan(H, compute_dtype, "fwd")["ok"]
            and (not need_grad
                 or recurrence_plan(H, compute_dtype, "bwd")["ok"]))


def recurrence_plan_on_card(H: int, compute_dtype: torch.dtype, kind: str,
                            device: int = 0) -> dict:
    """The plan as the kernel library computes it on CUDA device `device`
    (lstm_fwd_rec_plan / lstm_bwd_plan): n, threads, smem, w_on_chip, and
    active_clusters, the clusters of that size the card holds at once.
    Raises where a launch would."""
    from lstm_rnn_tpu_torch.ops import _build
    lib = _build.load()
    info = (ctypes.c_int * 5)()
    fn = lib.lstm_fwd_rec_plan if kind == "fwd" else lib.lstm_bwd_plan
    err = fn(H, int(compute_dtype == torch.bfloat16), device,
             ctypes.cast(info, ctypes.c_void_p))
    _raise_on(err, f"the {kind} recurrence's plan at H={H}")
    return dict(n=info[0], threads=info[1], smem=info[2],
                w_on_chip=bool(info[3]), active_clusters=info[4])


def activation_probe(x: torch.Tensor) -> torch.Tensor:
    """[4, n] f32 of a CUDA f32 x [n], as the recurrence kernels compute
    them: the plain sigmoid (bf16 mode) by the correctly rounded
    reciprocal, the same by the IEEE division, CURRENNT's logistic by the
    reciprocal, and by the division (csrc/lstm_fwd.cu act_probe_kernel)."""
    from lstm_rnn_tpu_torch.ops import _build
    x = x.float().contiguous()
    out = torch.empty((4, x.numel()), dtype=torch.float32, device=x.device)
    err = _build.load().lstm_act_probe(_ptr(x), _ptr(out), x.numel(),
                                       x.device.index, _stream(x))
    _raise_on(err, "lstm_act_probe launch")
    return out


@functools.lru_cache(maxsize=None)
def _check_plan(H: int, compute_dtype, kind: str) -> None:
    """Refuse, before a launch, a width whose recurrence no CTA takes
    (cached: it runs before every launch)."""
    plan = recurrence_plan(H, compute_dtype, kind)
    if not plan["ok"]:
        raise ValueError(
            f"H={H} is too wide for the {kind} recurrence kernel: a CTA of "
            f"its cluster of {plan['n']} would need {plan['threads']} "
            f"threads (at most {REC_MAX_THREADS}) and {plan['state']:,} "
            f"bytes of shared memory (at most {SMEM_OPTIN:,})")


def _check_cuda_operands(x, **named):
    """Every operand on x's device and contiguous, in the dtype its kernel
    reads."""
    named = {"x": x, **named}
    for name, t in named.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in ("x", "w_in", "w_rec") and t.dtype not in COMPUTE_DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
        if (name in ("peep", "bias", "c", "h0", "c0", "dhf", "dcf")
                and t.dtype != torch.float32):
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if name == "lengths" and t.dtype != torch.int32:
            raise TypeError(f"lengths must be int32, got {t.dtype}")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _raise_on(err: int, what: str) -> None:
    if err:
        from lstm_rnn_tpu_torch.ops import _build
        raise RuntimeError(f"{what} failed: CUDA error {err} "
                           f"({_build.load().lstm_err_str(err).decode()})")


def _launch_proj(x, w_in, bias, bias_mult: float, x3: bool = False):
    """Input projection a[d] = x . w_in[d] + bias_mult * bias[d] into an
    f32 [D, T, B, 4H] buffer. x and w_in share the compute dtype; x3 (f32)
    takes the engine's 3x instance."""
    from lstm_rnn_tpu_torch.ops import _build
    T, B, P = x.shape
    D, _, G = w_in.shape
    a = torch.empty((D, T, B, G), dtype=torch.float32, device=x.device)
    err = _build.load().lstm_fwd_proj(
        _ptr(x), _ptr(w_in), _ptr(bias), _ptr(a), T * B, P, G, D,
        ctypes.c_float(bias_mult), int(x.dtype == torch.bfloat16), int(x3),
        x.device.index, _stream(x))
    _raise_on(err, "lstm_fwd_proj launch")
    count_launches("proj", x3=x3)
    return a


def _rec_w_is_bf16(w_rec) -> bool:
    """The recurrence kernels read four adjacent W_rec entries in one vector
    load: refuse a misaligned w_rec. True for bf16 mode."""
    if w_rec.data_ptr() % (4 * w_rec.element_size()):
        raise ValueError(f"w_rec must be {4 * w_rec.element_size()}-byte "
                         f"aligned (a contiguous copy is)")
    return w_rec.dtype == torch.bfloat16


def _launch_rec(a, w_rec, peep, lengths, save: bool = False):
    """Recurrence over the projected a [D, T, B, 4H] -> h [T, B, D*H] in
    the storage dtype of w_rec's compute dtype; save=True also returns the
    residuals c [D, T, B, H] f32 and gates [D, T, B, 4H]."""
    from lstm_rnn_tpu_torch.ops import _build
    D, T, B, G = a.shape
    H = G // 4
    bf16 = _rec_w_is_bf16(w_rec)
    sdtype = torch.bfloat16 if bf16 else torch.float32
    _check_plan(H, sdtype, "fwd")
    out = torch.empty((T, B, D * H), dtype=sdtype, device=a.device)
    c = g = None
    if save:
        c = torch.empty((D, T, B, H), dtype=torch.float32, device=a.device)
        g = torch.empty((D, T, B, G), dtype=sdtype, device=a.device)
    err = _build.load().lstm_fwd_rec(
        _ptr(a), _ptr(w_rec), _ptr(peep), _ptr(lengths), _ptr(out),
        _ptr(c) if save else None, _ptr(g) if save else None,
        T, B, H, D, int(bf16), a.device.index, _stream(a))
    _raise_on(err, "lstm_fwd_rec launch")
    return (out, c, g) if save else out


def _launch_rec_carry(a, w_rec, peep, lengths, mask, h0, c0, carry_t: int,
                      dir_offset: int, save: bool = False):
    """The carry variant of the recurrence over the projected a
    [D, T, B, 4H]: (h [T, B, D*H] in the storage dtype, (hf, cf)
    [D, B, H] f32). mask: [B, T] uint8 or None. save=True (mask None) is
    the K6b forward: (h, c, gates, (hf, cf)) with the residuals of
    _launch_rec(save=True)."""
    from lstm_rnn_tpu_torch.ops import _build
    D, T, B, G = a.shape
    H = G // 4
    bf16 = _rec_w_is_bf16(w_rec)
    sdtype = torch.bfloat16 if bf16 else torch.float32
    _check_plan(H, sdtype, "fwd")
    out = torch.empty((T, B, D * H), dtype=sdtype, device=a.device)
    hf = torch.empty((D, B, H), dtype=torch.float32, device=a.device)
    cf = torch.empty_like(hf)
    lib = _build.load()
    if save:
        c = torch.empty((D, T, B, H), dtype=torch.float32, device=a.device)
        g = torch.empty((D, T, B, G), dtype=sdtype, device=a.device)
        err = lib.lstm_fwd_rec_carry_save(
            _ptr(a), _ptr(w_rec), _ptr(peep), _ptr(lengths), _ptr(h0),
            _ptr(c0), _ptr(out), _ptr(c), _ptr(g), _ptr(hf), _ptr(cf), T, B,
            H, D, carry_t, dir_offset, int(bf16), a.device.index, _stream(a))
        _raise_on(err, "lstm_fwd_rec_carry_save launch")
        return out, c, g, (hf, cf)
    err = lib.lstm_fwd_rec_carry(
        _ptr(a), _ptr(w_rec), _ptr(peep), _ptr(lengths),
        _ptr(mask) if mask is not None else None, _ptr(h0), _ptr(c0),
        _ptr(out), _ptr(hf), _ptr(cf), T, B, H, D, carry_t, dir_offset,
        int(bf16), a.device.index, _stream(a))
    _raise_on(err, "lstm_fwd_rec_carry launch")
    return out, (hf, cf)


def _launch_bwd(x, w_in, w_rec, peep, lengths, h, c, gates, dh, bias_mult,
                clip, compute_dtype, need_dx, carry=None, x3=False):
    """BPTT, weight gradients and dx (csrc/lstm_bwd.cu). dh is in the
    storage dtype. carry = (h0, c0, dhf, dcf, carry_t, dir_offset) runs
    the carry variant and also returns (dh0, dc0); x3 (f32) runs the
    weight gradients and dx in the engine's 3x instance."""
    from lstm_rnn_tpu_torch.ops import _build
    lib = _build.load()
    T, B, P = x.shape
    D, _, G = w_in.shape
    H = G // 4
    hp = (H + 3) // 4 * 4
    dev = x.device
    sdtype = storage_dtype(compute_dtype)
    _check_plan(H, compute_dtype, "bwd")
    # W_rec^T with zero-padded columns, as csrc/lstm_bwd.cu takes it (each
    # CTA of the BPTT's cluster stages its cells' columns once)
    w_rec_t = torch.zeros((D, G, hp), dtype=compute_dtype, device=dev)
    w_rec_t[:, :, :H] = w_rec.to(compute_dtype).transpose(1, 2)
    xc = x.to(compute_dtype).contiguous()
    w_in_c = w_in.to(compute_dtype).contiguous()
    nsplit = lib.lstm_bwd_splits(T * B)
    n_w = D * P * G + D * H * G
    f32 = dict(dtype=torch.float32, device=dev)
    da = torch.empty((D, T, B, G), dtype=sdtype, device=dev)
    # one dpeep/dbias partial per cluster's group of rows
    pb_part = torch.empty((-(-B // REC_ROWS), D, 7 * H), **f32)
    w_part = torch.empty((nsplit, n_w), **f32)
    w_out = torch.empty(n_w, **f32)
    pb_out = torch.empty((D, 7 * H), **f32)
    dx = torch.empty((T, B, P), **f32) if need_dx else None
    tail = (ctypes.c_float(bias_mult), int(clip), int(need_dx),
            int(compute_dtype == torch.bfloat16), int(x3), dev.index,
            _stream(x))
    if carry is None:
        err = lib.lstm_bwd(
            _ptr(xc), _ptr(dh), _ptr(gates), _ptr(c), _ptr(h), _ptr(w_in_c),
            _ptr(w_rec_t), _ptr(peep), _ptr(lengths), _ptr(da),
            _ptr(pb_part), _ptr(w_part), _ptr(w_out), _ptr(pb_out),
            _ptr(dx) if need_dx else None, T, B, P, H, D, *tail)
        _raise_on(err, "lstm_bwd launch")
    else:
        h0, c0, dhf, dcf, carry_t, dir_offset = carry
        # h0 as dW_rec's edge row reads it: rounded to the storage dtype
        h0s = h0.to(sdtype).contiguous()
        dh0 = torch.empty((D, B, H), **f32)
        dc0 = torch.empty((D, B, H), **f32)
        err = lib.lstm_bwd_carry(
            _ptr(xc), _ptr(dh), _ptr(gates), _ptr(c), _ptr(h), _ptr(w_in_c),
            _ptr(w_rec_t), _ptr(peep), _ptr(lengths), _ptr(h0s), _ptr(c0),
            _ptr(dhf), _ptr(dcf), _ptr(da), _ptr(pb_part), _ptr(w_part),
            _ptr(w_out), _ptr(pb_out), _ptr(dx) if need_dx else None,
            _ptr(dh0), _ptr(dc0), T, B, P, H, D, carry_t, dir_offset, *tail)
        _raise_on(err, "lstm_bwd_carry launch")
    count_launches("dW_in", "dW_rec", *(("dx",) if need_dx else ()), x3=x3)
    grads = (dx, w_out[:D * P * G].view(D, P, G),
             w_out[D * P * G:].view(D, H, G),
             pb_out[:, :3 * H].reshape(D, 3, H),
             pb_out[:, 3 * H:].contiguous())
    return grads if carry is None else grads + (dh0, dc0)
