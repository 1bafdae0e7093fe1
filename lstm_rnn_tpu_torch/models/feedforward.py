"""Feedforward and softmax layers, in plain torch.

The counterpart of lstm_rnn_tpu/models/feedforward.py. The reference
(`FeedForwardLayer.cu:144-153`) computes one GEMM over all timesteps, adds
`bias_multiplier * bias` and applies the activation. `SoftmaxLayer.cu`
centres the exponent by `offset = 0.5 * (min + max)` per pattern, with the
max search starting at FLT_MIN, and exponentiates with `safeExp`; both
quirks are kept. The JAX package leaves these layers to XLA outside any
kernel, so the port leaves them to torch.

Precision: float32 mode is true fp32 (callers keep TF32 off). bfloat16 mode
rounds both operands to bf16 and accumulates in float32, as the JAX
package's bf16 einsum with float32 accumulation: on the CPU as f32 products
of the rounded operands (exact per product); on the card on the tensor
cores (`_Bf16Product`: `torch.mm` on bf16 operands with f32 output), the
same values summed in another order. Its two gradient products take the
f32 cotangent as two bf16 parts (hi + lo, 16 bits of its 24), so that they
too run on the tensor cores and give the CPU's gradients to well inside the
bf16 rounding that the operands' casts apply to them.
"""

from __future__ import annotations

import torch

from lstm_rnn_tpu_torch.ops.activations import ACTIVATIONS, REAL_MIN, safe_exp


def round_operand(t: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """A matmul operand in the compute dtype's precision, held in float32
    (float64 in the CPU scan route's float64 mode)."""
    if compute_dtype == torch.float64:
        return t.to(torch.float64)
    return t.to(compute_dtype).float()


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b of bf16 operands with f32 sums and f32 output (the tensor
    cores' product on the card)."""
    return torch.mm(a, b, out_dtype=torch.float32)


class _Bf16Product(torch.autograd.Function):
    """x2 . W [M, L] f32 of x2 [M, P] and W [P, L] rounded to bf16, on the
    card's tensor cores. The gradients are those of round_operand's
    product (each rounded to bf16 by the cast's backward, then to the
    input's dtype), their products taking the f32 cotangent as bf16 hi +
    lo."""

    @staticmethod
    def forward(ctx, x2, W):
        xb, wb = x2.to(torch.bfloat16), W.to(torch.bfloat16)
        ctx.save_for_backward(xb, wb)
        ctx.dtypes = (x2.dtype, W.dtype)
        return _mm_f32(xb, wb)

    @staticmethod
    def backward(ctx, g):
        xb, wb = ctx.saved_tensors
        hi = g.to(torch.bfloat16)
        lo = (g - hi.float()).to(torch.bfloat16)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            wt = wb.t()
            dx = (_mm_f32(hi, wt) + _mm_f32(lo, wt)).to(
                torch.bfloat16).to(ctx.dtypes[0])
        if ctx.needs_input_grad[1]:
            xt = xb.t()
            dw = (_mm_f32(xt, hi) + _mm_f32(xt, lo)).to(
                torch.bfloat16).to(ctx.dtypes[1])
        return dx, dw


def _product(x: torch.Tensor, W: torch.Tensor,
             compute_dtype: torch.dtype) -> torch.Tensor:
    """x [..., P] . W [P, L] in float32 at the compute dtype's precision:
    bf16 mode on the card on the tensor cores, else round_operand's f32
    matmul."""
    if compute_dtype == torch.bfloat16 and x.is_cuda:
        a = _Bf16Product.apply(x.reshape(-1, x.shape[-1]), W)
        return a.reshape(*x.shape[:-1], W.shape[-1])
    return torch.matmul(round_operand(x, compute_dtype),
                        round_operand(W, compute_dtype))


def feedforward_forward(params, x: torch.Tensor, activation: str,
                        bias_mult: float,
                        compute_dtype: torch.dtype = torch.float32):
    """x: [T, B, P] -> [T, B, L] float32. params: {"W": [P, L], "b": [L]}."""
    a = _product(x, params["W"], compute_dtype)
    a = a + bias_mult * params["b"]
    return ACTIVATIONS[activation](a)


def softmax_forward(params, x: torch.Tensor, bias_mult: float,
                    compute_dtype: torch.dtype = torch.float32):
    """Feedforward-identity + CURRENNT softmax. x: [T, B, P] -> [T, B, L]."""
    a = feedforward_forward(params, x, "identity", bias_mult, compute_dtype)
    offset = 0.5 * (a.amin(dim=-1, keepdim=True)
                    + torch.clamp_min(a.amax(dim=-1, keepdim=True), REAL_MIN))
    e = safe_exp(a - offset)
    return e / e.sum(dim=-1, keepdim=True)
