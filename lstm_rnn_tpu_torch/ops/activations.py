"""Activation functions with CURRENNT-exact numerics, in torch.

The counterpart of lstm_rnn_tpu/ops/activations.py. Two quirks of the
reference (`currennt_lib/src/activation_functions/*.cuh`,
`helpers/safeExp.cuh`, `NumericLimits.cuh`) matter for parity:

- `Tanh` is `2*logistic(2x) - 1`, not libm tanh; in float32 it rounds and
  saturates differently, so it is reproduced literally;
- `logistic` saturates hard at +-expLimit, and `safeExp` clamps:
  x <= -1e30 -> 0, x >= 88.722839 -> FLT_MAX, else exp(x).

`grad_clip` is the reference's limitedError (`helpers/limitedError.cuh`):
identity forward, the cotangent clamped to [-1, 1] on the way back. Wrapping
each LSTM gate preactivation with it makes autograd through the scan path
reproduce the hand-written BPTT's delta clipping (LstmLayer.cu:281-284).
"""

from __future__ import annotations

import torch

# Float32 numeric limits used by the reference (NumericLimits.cuh).
REAL_MIN = 1.1754944e-38
REAL_MAX = 3.4028235e38
EXP_LIMIT = 88.722839
LOG_ZERO = -1e30


def logistic(x: torch.Tensor) -> torch.Tensor:
    """Reference Logistic.cuh: 1/(1+exp(-x)) with hard saturation at +-expLimit."""
    y = torch.sigmoid(x)
    y = torch.where(x >= EXP_LIMIT, torch.ones_like(y), y)
    return torch.where(x <= -EXP_LIMIT, torch.zeros_like(y), y)


def tanh2(x: torch.Tensor) -> torch.Tensor:
    """Reference Tanh.cuh: 2*logistic(2x) - 1 (NOT libm tanh)."""
    return 2.0 * logistic(2.0 * x) - 1.0


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def maxmin1(x: torch.Tensor) -> torch.Tensor:
    """Maxmin1.cuh: 2*logistic(x) - 1, range (-1, 1)."""
    return 2.0 * logistic(x) - 1.0


def maxmin2(x: torch.Tensor) -> torch.Tensor:
    """Maxmin2.cuh: 4*logistic(x) - 2, range (-2, 2). In the reference's
    activation library but reachable from no layer type."""
    return 4.0 * logistic(x) - 2.0


def max2min0(x: torch.Tensor) -> torch.Tensor:
    """Max2min0.cuh: 2*logistic(x), range (0, 2). Reachable from no layer
    type, like maxmin2."""
    return 2.0 * logistic(x)


def safe_exp(x: torch.Tensor) -> torch.Tensor:
    """Reference safeExp.cuh: clamped exp."""
    e = torch.exp(torch.clamp(x, LOG_ZERO, EXP_LIMIT))
    # REAL_MAX as a Python float lies just above FLT_MAX, which torch
    # refuses to round; FLT_MAX is its float32 value
    e = torch.where(x >= EXP_LIMIT,
                    torch.full_like(x, torch.finfo(torch.float32).max), e)
    return torch.where(x <= LOG_ZERO, torch.zeros_like(x), e)


class _GradClip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.clamp(g, -1.0, 1.0)


def grad_clip(x: torch.Tensor) -> torch.Tensor:
    """Identity forward; clamps the cotangent to [-1, 1] on the way back."""
    return _GradClip.apply(x)


ACTIVATIONS = {
    "tanh": tanh2,
    "logistic": logistic,
    "identity": identity,
    "maxmin1": maxmin1,
    "maxmin2": maxmin2,
    "max2min0": max2min0,
}
