"""Feedforward and softmax layers, in plain torch.

The counterpart of lstm_rnn_tpu/models/feedforward.py. The reference
(`FeedForwardLayer.cu:144-153`) computes one GEMM over all timesteps, adds
`bias_multiplier * bias` and applies the activation. `SoftmaxLayer.cu`
centres the exponent by `offset = 0.5 * (min + max)` per pattern, with the
max search starting at FLT_MIN, and exponentiates with `safeExp`; both
quirks are kept. The JAX package leaves these layers to XLA outside any
kernel, so the port leaves them to torch.

Precision: float32 mode is true fp32 (callers keep TF32 off). bfloat16 mode
rounds both operands to bf16 and multiplies in float32, which is exact per
product, so the result is a bf16-operand product with float32 accumulation
on any device.
"""

from __future__ import annotations

import torch

from lstm_rnn_tpu_torch.ops.activations import ACTIVATIONS, REAL_MIN, safe_exp


def round_operand(t: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """A matmul operand in the compute dtype's precision, held in float32."""
    return t.to(compute_dtype).float()


def feedforward_forward(params, x: torch.Tensor, activation: str,
                        bias_mult: float,
                        compute_dtype: torch.dtype = torch.float32):
    """x: [T, B, P] -> [T, B, L] float32. params: {"W": [P, L], "b": [L]}."""
    a = torch.matmul(round_operand(x, compute_dtype),
                     round_operand(params["W"], compute_dtype))
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
