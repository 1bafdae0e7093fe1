"""The port's carry-capable LSTM forward (lstm_rnn_tpu_torch.ops.lstm_cell.
lstm_scan_fused_carry: streaming serving's chunk) against the JAX
package's `lstm_scan_fused_carry` in interpret mode, as
tests/test_pallas_carry.py runs it, on the same numpy inputs.

On the CPU the port runs the kernel's plain twin,
`lstm_scan_carry_reference`; the Hopper kernel itself is held against the
twin on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lstm_rnn_tpu.ops.lstm_cell import \
    lstm_scan_fused_carry as jax_fused_carry
from lstm_rnn_tpu_torch.ops.lstm_cell import (lstm_scan_carry_reference,
                                              lstm_scan_fused,
                                              lstm_scan_fused_carry)

T, B, P, BIAS_MULT = 9, 5, 7, 0.7


def _mask(t=T):
    """[B, T] step validity with every pattern a streamed chunk has: a full
    row, a row that ends mid-chunk, a gap and a restart, a row that starts
    mid-chunk, and a row with no valid step."""
    m = np.ones((B, t), np.float32)
    m[1, 4:] = 0.0
    m[2, 2:4] = 0.0
    m[3, :5] = 0.0
    m[4] = 0.0
    return m


# (D, H, compute dtype, carry_t, dir_offset, with a step mask)
CASES = {
    "uni-f32": (1, 6, "float32", None, 0, False),
    "bi-f32": (2, 6, "float32", None, 0, False),
    "uni-carry_t-f32": (1, 6, "float32", T - 3, 0, False),
    "uni-desc-f32": (1, 6, "float32", None, 1, False),
    "uni-mask-f32": (1, 6, "float32", None, 0, True),
    "uni-mask-carry_t-f32": (1, 6, "float32", T - 3, 0, True),
    "uni-desc-mask-f32": (1, 6, "float32", None, 1, True),
    "bi-mask-f32": (2, 6, "float32", None, 0, True),
    "uni-mask-h130-bf16": (1, 130, "bfloat16", None, 0, True),
    "bi-bf16": (2, 6, "bfloat16", None, 0, False),
    "uni-carry_t-bf16": (1, 6, "bfloat16", T - 3, 0, False),
}


def _inputs(case):
    d, h, _, _, _, with_mask = CASES[case]
    rng = np.random.RandomState(sorted(CASES).index(case))
    u = lambda *s: rng.uniform(-0.5, 0.5, s).astype(np.float32)  # noqa
    x = rng.randn(T, B, P).astype(np.float32)
    lengths = np.array([T, 4, 1, 0, T], np.int32)
    # non-zero carries, of the size a streamed state reaches
    h0, c0 = u(d, B, h) * 1.5, u(d, B, h) * 3.0
    return (x, u(d, P, 4 * h), u(d, h, 4 * h), u(d, 3, h), u(d, 4 * h),
            lengths, h0, c0, _mask() if with_mask else None)


@functools.lru_cache(maxsize=None)
def _jax_out(case):
    _, _, dtype, carry_t, dir_offset, _ = CASES[case]
    *ops, mask = _inputs(case)
    y, (hf, cf) = jax_fused_carry(
        *map(jnp.asarray, ops), BIAS_MULT, True, True, jnp.dtype(dtype),
        True, carry_t, dir_offset,
        None if mask is None else jnp.asarray(mask))
    return (np.asarray(y.astype(jnp.float32)), np.asarray(hf),
            np.asarray(cf))


def _port_out(case):
    _, _, dtype, carry_t, dir_offset, _ = CASES[case]
    *ops, mask = _inputs(case)
    with torch.inference_mode():
        y, (hf, cf) = lstm_scan_fused_carry(
            *map(torch.from_numpy, ops), BIAS_MULT, True,
            getattr(torch, dtype), True, carry_t, dir_offset,
            None if mask is None else torch.from_numpy(mask))
    assert y.dtype == (torch.bfloat16 if dtype == "bfloat16"
                       else torch.float32)
    assert hf.dtype == cf.dtype == torch.float32
    return y.float().numpy(), hf.numpy(), cf.numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_carry_matches_jax(case):
    """h, hf and cf against the JAX kernel. f32: true-f32 products summed
    in another order. bf16: the same rounding points, but a different sum
    order can put a stored h on the other side of a bf16 rounding boundary
    and the recurrence carries it: one bf16 ulp of each output's largest
    entry."""
    dtype = CASES[case][2]
    for name, got, want in zip(("h", "hf", "cf"), _port_out(case),
                               _jax_out(case)):
        assert got.shape == want.shape, name
        scale = float(np.abs(want).max())
        tol = 1e-5 if dtype == "float32" else 2.0 ** -8 * max(scale, 1.0)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=name)


def test_mask_zeroes_state_at_none_steps():
    """The row with no valid step has h = 0 everywhere and a zero final
    state, whatever it entered with; the row that starts mid-chunk is zero
    before its start."""
    y, hf, cf = _port_out("uni-mask-f32")
    assert not y[:, 4].any() and not hf[0, 4].any() and not cf[0, 4].any()
    assert not y[:5, 3].any()


def test_zero_carry_equals_plain_forward():
    """With zero carries and no mask, the carry twin is the plain forward's
    twin, bit for bit, and its final state is the last valid step's."""
    x, w_in, w_rec, peep, bias, lengths, h0, _, _ = map(
        lambda a: None if a is None else torch.from_numpy(a),
        _inputs("bi-f32"))
    z = torch.zeros_like(h0)
    args = (x, w_in, w_rec, peep, bias, lengths)
    y, (hf, cf) = lstm_scan_fused_carry(*args, z, z)
    assert torch.equal(y, lstm_scan_fused(*args))
    H = w_rec.shape[1]
    # row 0 runs all T steps: d = 0 ends at T-1, d = 1 at 0
    assert torch.equal(hf[0, 0], y[T - 1, 0, :H])
    assert torch.equal(hf[1, 0], y[0, 0, H:])


@pytest.mark.parametrize("dir_offset", [0, 1])
def test_chained_chunks_equal_one_call(dir_offset):
    """Two calls chained through (hf, cf) equal one call on the whole
    sequence, ascending (chunks in time order) and descending (dir_offset
    = 1: the later chunk first)."""
    x, w_in, w_rec, peep, bias, _, h0, c0, mask = map(
        torch.from_numpy, _inputs("uni-desc-mask-f32"))
    lengths = torch.full((B,), T, dtype=torch.int32)
    w = (w_in, w_rec, peep, bias)
    run = functools.partial(lstm_scan_fused_carry, dir_offset=dir_offset)
    y, (hf, cf) = run(x, *w, lengths, h0, c0, step_mask=mask)
    cut = 4
    parts = [(x[:cut], mask[:, :cut]), (x[cut:], mask[:, cut:])]
    if dir_offset:
        parts.reverse()
    state, ys = (h0, c0), []
    for xp, mp in parts:
        yp, state = run(xp, *w, lengths, *state, step_mask=mp)
        ys.append(yp)
    if dir_offset:
        ys.reverse()
    np.testing.assert_allclose(torch.cat(ys).numpy(), y.numpy(), rtol=0,
                               atol=1e-6)
    for got, want in zip(state, (hf, cf)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-6)


def _torch_args(case="uni-f32", requires_grad=False):
    out = []
    for a in _inputs(case)[:8]:
        t = torch.from_numpy(a)
        if requires_grad and t.dtype == torch.float32:
            t.requires_grad_(True)
        out.append(t)
    return out


@pytest.mark.parametrize("case", ["bi-f32", "uni-desc-f32"])
def test_descending_carry_rejects_carry_t(case):
    """A descending direction enters at t = T-1: trailing padding
    (carry_t < T) would zero its incoming carry, so it is refused, as the
    JAX package refuses it."""
    dir_offset = CASES[case][4]
    with pytest.raises(ValueError, match="descending"):
        lstm_scan_fused_carry(*_torch_args(case), carry_t=T - 2,
                              dir_offset=dir_offset)


@pytest.mark.parametrize("with_mask, match", [
    (True, "inference-only"),
    pytest.param(False, "LstmScanFusedCarry", id="False-K6b")])
def test_gradient_raises(with_mask, match):
    """Under autograd the masked carry kernel has no backward: with a step
    mask it says inference-only, as the JAX package does; without one the
    layer goes through the carry backward (K6b, LstmScanFusedCarry;
    tests/test_torch_carry_grad.py holds its gradients)."""
    mask = torch.from_numpy(_mask()) if with_mask else None
    if with_mask:
        with pytest.raises(NotImplementedError, match=match):
            lstm_scan_fused_carry(*_torch_args(requires_grad=True),
                                  step_mask=mask)
    else:
        y, _ = lstm_scan_fused_carry(*_torch_args(requires_grad=True))
        assert match in type(y.grad_fn).__name__
    with torch.no_grad():  # inference runs
        lstm_scan_fused_carry(*_torch_args(requires_grad=True),
                              step_mask=mask)


@pytest.mark.parametrize("kwargs, match", [
    ({"h0": torch.zeros(1, B, 5)}, "h0 has shape"),
    ({"c0": torch.zeros(2, B, 6)}, "c0 has shape"),
    ({"step_mask": torch.ones(T, B)}, "step_mask has shape"),
    ({"carry_t": 0}, "carry_t"),
    ({"carry_t": T + 1}, "carry_t"),
    ({"dir_offset": 2}, "dir_offset"),
])
def test_rejects_bad_carry_operands(kwargs, match):
    args = _torch_args()
    for i, name in ((6, "h0"), (7, "c0")):
        if name in kwargs:
            args[i] = kwargs.pop(name)
    with pytest.raises(ValueError, match=match):
        lstm_scan_fused_carry(*args, **kwargs)


def test_cpu_runs_the_twin_and_counts_no_launch():
    before = lstm_scan_fused_carry.launches
    args = _torch_args()
    y, (hf, _) = lstm_scan_fused_carry(*args)
    want, (hf_r, _) = lstm_scan_carry_reference(*args)
    assert torch.equal(y, want) and torch.equal(hf, hf_r)
    assert lstm_scan_fused_carry.launches == before
