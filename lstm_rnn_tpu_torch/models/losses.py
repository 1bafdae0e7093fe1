"""Post-output (loss) layers with the reference's values AND gradients.

Counterpart of lstm_rnn_tpu/models/losses.py. The reference has 7
post-output layers (LayerFactory.cu:66-87), each with a hand-written error
and backward gradient; several gradients are deliberately NOT the analytic
derivative of the error, so each loss is a `torch.autograd.Function` whose
backward returns the reference's `outputErrors` (the JAX package's
custom_vjp):

- weighted_sse's gradient is (y - t) w, without the second w;
- rmse's gradient is the per-pattern rmse times (y - t);
- ce's gradient is clamped to +-100;
- sse_mask is exported under the type name "wf".

Inputs y are the output layer's activations [T, B, L]; padding slots
(pattype 0) add 0 to the error and get 0 gradient. Errors are sums over
the fraction (the trainer divides by the sequence count). These serve the
unfused path: `--lstm_backend scan`, and nets whose tail is not softmax ->
multiclass_classification (the fused tail is ops/softmax_ce.py).
"""

from __future__ import annotations

import torch

from lstm_rnn_tpu_torch.ops.activations import REAL_MIN


def _valid(pattypes, dtype):
    return (pattypes != 0).to(dtype)[..., None]


def _loss_fn(value, grad):
    """A loss from its error value(y, targets, pattypes) and its reference
    gradient grad(y, targets, pattypes) (dE/dy for a cotangent of 1)."""

    class _Loss(torch.autograd.Function):
        @staticmethod
        def forward(ctx, y, targets, pattypes):
            ctx.save_for_backward(y, targets, pattypes)
            return value(y, targets, pattypes)

        @staticmethod
        def backward(ctx, g):
            y, targets, pattypes = ctx.saved_tensors
            return g * grad(y, targets, pattypes), None, None

    def loss(y, targets, pattypes):
        return _Loss.apply(y, targets, pattypes)

    loss.__doc__ = value.__doc__
    return loss


# sse: E = 0.5 sum (t - y)^2, grad y - t (SsePostOutputLayer.cu)
def _sse(y, t, pt):
    """0.5 * sum((t - y)^2) over valid frames."""
    d = (t - y) * _valid(pt, y.dtype)
    return 0.5 * torch.sum(d * d)


sse = _loss_fn(_sse, lambda y, t, pt: (y - t) * _valid(pt, y.dtype))


# weighted_sse: targets interleaved (t, w); E = 0.5 sum ((y - t) w)^2,
# grad (y - t) w without the second w (WeightedSsePostOutputLayer.cu:61,89)
def _wsse(y, t, pt):
    """0.5 * sum(((y - t) * w)^2), targets interleaved (t, w)."""
    d = (y - t[..., 0::2]) * t[..., 1::2] * _valid(pt, y.dtype)
    return 0.5 * torch.sum(d * d)


weighted_sse = _loss_fn(
    _wsse, lambda y, t, pt: (y - t[..., 0::2]) * t[..., 1::2]
    * _valid(pt, y.dtype))


# rmse: per-pattern rmse = sqrt(mean((y - t)^2)); E = sum of them;
# grad rmse * (y - t) (RmsePostOutputLayer.cu:93)
def _rmses(y, t, pt):
    d = y - t
    return torch.sqrt(torch.mean(d * d, dim=-1)) * (pt != 0).to(y.dtype)


def _rmse(y, t, pt):
    """sum over valid frames of sqrt(mean((y - t)^2))."""
    return torch.sum(_rmses(y, t, pt))


rmse = _loss_fn(_rmse, lambda y, t, pt: _rmses(y, t, pt)[..., None] * (y - t))


# ce: E = sum t log(max(t, eps) / max(y, eps)), grad clamp(-t / max(y,
# eps), -100, 100) (CePostOutputLayer.cu:61-96)
def _ce(y, t, pt):
    """sum(t * log(max(t, REAL_MIN) / max(y, REAL_MIN)))."""
    ft = torch.clamp_min(t, REAL_MIN)
    fy = torch.clamp_min(y, REAL_MIN)
    return torch.sum(t * torch.log(ft / fy) * _valid(pt, y.dtype))


ce = _loss_fn(_ce, lambda y, t, pt: torch.clamp(
    -t / torch.clamp_min(y, REAL_MIN), -100.0, 100.0) * _valid(pt, y.dtype))


# sse_mask ("wf"): targets interleaved (o, i); E = 0.5 sum (y i - o)^2,
# grad (y i - o) i (SseMaskPostOutputLayer.cu)
def _sse_mask(y, t, pt):
    """0.5 * sum((y * i - o)^2), targets interleaved (o, i)."""
    d = (y * t[..., 1::2] - t[..., 0::2]) * _valid(pt, y.dtype)
    return 0.5 * torch.sum(d * d)


sse_mask = _loss_fn(
    _sse_mask, lambda y, t, pt: (y * t[..., 1::2] - t[..., 0::2])
    * t[..., 1::2] * _valid(pt, y.dtype))


# binary_classification: one logistic output, int classes {0, 1};
# E = -sum log p_target, grad -1/p (target > 0) or 1/p
# (BinaryClassificationLayer.cu)
def _bc_p(y, t):
    act = torch.clamp_min(y[..., 0], REAL_MIN)
    # the target probability is not clamped (BinaryClassificationLayer.cu:
    # 61-63): a confidently wrong output reports +inf, as the reference
    return torch.where(t > 0, act, 1.0 - act)


def _bc(y, t, pt):
    """-sum(log p[target]) over valid frames."""
    return torch.sum(-torch.log(_bc_p(y, t)) * (pt != 0).to(y.dtype))


binary_classification = _loss_fn(_bc, lambda y, t, pt: (torch.where(
    t > 0, -1.0 / _bc_p(y, t), 1.0 / _bc_p(y, t))
    * (pt != 0).to(y.dtype))[..., None])


def binary_correct_count(y, target_classes, pattypes):
    """Correct classifications at threshold 0.5
    (BinaryClassificationLayer.cu:69-85)."""
    valid = pattypes != 0
    correct = (target_classes.float() > 0.5) == (y[..., 0] > 0.5)
    return torch.sum(valid & correct).to(torch.int32)


# multiclass_classification: sparse labels after a softmax;
# E = -sum log max(p[target], REAL_MIN), grad -1/max(p[target], REAL_MIN)
# at the target only (MulticlassClassificationLayer.cu:195-240); target -1
# marks a dummy frame
def _mc_p(y, t):
    p = torch.gather(y, -1, t.clamp_min(0).long()[..., None])[..., 0]
    return torch.clamp_min(p, REAL_MIN)


def _mc(y, t, pt):
    """-sum(log max(p[target], REAL_MIN)) over frames with target >= 0."""
    return -torch.sum(torch.where(t >= 0, torch.log(_mc_p(y, t)), 0.0))


def _mc_grad(y, t, pt):
    val = torch.where(t >= 0, -1.0 / _mc_p(y, t), 0.0)
    onehot = torch.zeros_like(y).scatter_(-1, t.clamp_min(0).long()[..., None],
                                          1.0)
    return onehot * val[..., None]


multiclass_classification = _loss_fn(_mc, _mc_grad)


def multiclass_correct_count(y, target_classes, pattypes):
    """Argmax accuracy counter (MulticlassClassificationLayer.cu:71-106):
    ties go to the first maximal index, as in the reference."""
    valid = target_classes >= 0
    est = torch.argmax(y, dim=-1)
    return torch.sum(valid & (est == target_classes)).to(torch.int32)


# name -> (fn, kind): "regression" (real targets) or "classification"
# (int targets)
LOSSES = {
    "sse": (sse, "regression"),
    "weighted_sse": (weighted_sse, "regression"),
    "weightedsse": (weighted_sse, "regression"),
    "rmse": (rmse, "regression"),
    "ce": (ce, "regression"),
    "sse_mask": (sse_mask, "regression"),
    "wf": (sse_mask, "regression"),
    "binary_classification": (binary_classification, "classification"),
    "multiclass_classification": (multiclass_classification,
                                  "classification"),
}
