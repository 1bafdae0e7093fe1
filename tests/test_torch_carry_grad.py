"""The port's carry kernels with gradients (K6b: lstm_fwd_save_carry,
lstm_bwd_carry and the autograd Function LstmScanFusedCarry behind
lstm_scan_fused_carry) against `jax.vjp` of the JAX package's
`lstm_scan_fused_carry` with its Pallas kernels in interpret mode, as
tests/test_pallas_carry.py runs it, on the same numpy inputs.

On the CPU the port runs the kernels' plain twins
(`lstm_scan_carry_reference(save=True)`, `lstm_scan_carry_bwd_reference`);
the Hopper kernels are held against the twins on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lstm_rnn_tpu.ops.lstm_cell import \
    lstm_scan_fused_carry as jax_fused_carry
from lstm_rnn_tpu_torch.ops.lstm_cell import (lstm_bwd_carry,
                                              lstm_fwd_save_carry,
                                              lstm_scan_bwd_reference,
                                              lstm_scan_carry_bwd_reference,
                                              lstm_scan_carry_reference,
                                              lstm_scan_fused_carry,
                                              lstm_scan_reference)

T, B, P, BIAS_MULT = 9, 5, 7, 0.7
# ragged, including 0 and T
LENGTHS = np.array([T, 4, 0, 1, T], np.int32)
# (D, H, compute dtype, carry_t, dir_offset, need_dx)
CASES = {
    "uni-f32": (1, 6, "float32", None, 0, True),
    "uni-carry_t-f32": (1, 6, "float32", T - 3, 0, True),
    "uni-desc-f32": (1, 6, "float32", None, 1, True),
    "uni-desc-nodx-f32": (1, 6, "float32", None, 1, False),
    "bi-f32": (2, 6, "float32", None, 0, True),
    "uni-bf16": (1, 6, "bfloat16", None, 0, True),
    "uni-carry_t-bf16": (1, 6, "bfloat16", T - 3, 0, True),
    "uni-desc-h130-bf16": (1, 130, "bfloat16", None, 1, True),
}
NAMES = ["dx", "dW_in", "dW_rec", "dpeep", "dbias", "dh0", "dc0"]


def _inputs(case):
    """x, the weights, (h0, c0) of the size a chained block hands on, and
    the cotangents of h, hf and cf; large enough that some deltas clip."""
    d, h = CASES[case][:2]
    rng = np.random.RandomState(sorted(CASES).index(case) + 40)
    u = lambda lo, hi, *s: rng.uniform(lo, hi, s).astype(np.float32)  # noqa
    x = rng.randn(T, B, P).astype(np.float32)
    ops = (x, u(-0.5, 0.5, d, P, 4 * h), u(-0.5, 0.5, d, h, 4 * h),
           u(-0.5, 0.5, d, 3, h), u(-0.5, 0.5, d, 4 * h))
    carry = (u(-0.9, 0.9, d, B, h), u(-3.0, 3.0, d, B, h))
    cts = ((8.0 * rng.randn(T, B, d * h)).astype(np.float32),
           u(-2.0, 2.0, d, B, h), u(-2.0, 2.0, d, B, h))
    return ops, carry, cts


@functools.lru_cache(maxsize=None)
def _jax(case):
    _, _, dtype, carry_t, dir_offset, need_dx = CASES[case]
    (x, *w), (h0, c0), (dh, dhf, dcf) = _inputs(case)

    def f(x_, w_in, w_rec, peep, bias, h0_, c0_):
        return jax_fused_carry(x_, w_in, w_rec, peep, bias,
                               jnp.asarray(LENGTHS), h0_, c0_, BIAS_MULT,
                               True, True, jnp.dtype(dtype), need_dx,
                               carry_t, dir_offset)
    (h, (hf, cf)), vjp = jax.vjp(
        f, *map(jnp.asarray, (x, *w, h0, c0)))
    grads = vjp((jnp.asarray(dh).astype(h.dtype),
                 (jnp.asarray(dhf), jnp.asarray(dcf))))
    return ([np.asarray(a, np.float32) for a in (h, hf, cf)],
            [np.asarray(g, np.float32) for g in grads])


def _port(case):
    """Through the autograd Function, as sequence parallelism calls it."""
    _, _, dtype, carry_t, dir_offset, need_dx = CASES[case]
    ops, carry, (dh, dhf, dcf) = _inputs(case)
    ts = [torch.tensor(a, requires_grad=True) for a in ops + carry]
    h, (hf, cf) = lstm_scan_fused_carry(
        *ts[:5], torch.tensor(LENGTHS), *ts[5:], BIAS_MULT, True,
        getattr(torch, dtype), need_dx, carry_t, dir_offset)
    grads = torch.autograd.grad(
        (h, hf, cf), ts, (torch.tensor(dh).to(h.dtype), torch.tensor(dhf),
                          torch.tensor(dcf)), allow_unused=True)
    return ([a.detach().float().numpy() for a in (h, hf, cf)],
            [None if g is None else g.numpy() for g in grads])


def _tolerance(dtype, ref):
    if dtype == "float32":
        # true f32 on both sides, sums in another order: ~1e-5 relative
        return 1e-5 * max(1.0, float(np.abs(ref).max()))
    # bf16 stores h, the gates and the deltas: a sum order that puts a value
    # on the other side of a bf16 rounding boundary moves every product
    # downstream by up to one bf16 ulp (2^-8) of the largest entry
    return 2.0 ** -8 * max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("case", sorted(CASES))
def test_carry_grad_matches_jax_vjp(case):
    """h, hf, cf and every gradient (x, the weights, h0, c0) against the JAX
    carry kernel's VJP: both directions (dir_offset 0 and 1), carry_t < T,
    f32 and bf16, non-zero carries and final-state cotangents, a row of
    length 0."""
    dtype, need_dx = CASES[case][2], CASES[case][5]
    outs_want, g_want = _jax(case)
    outs_got, g_got = _port(case)
    for name, got, want in zip(("h", "hf", "cf"), outs_got, outs_want):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=_tolerance(dtype, want),
                                   err_msg=name)
    for name, got, want in zip(NAMES, g_got, g_want):
        if got is None:  # need_dx=False: JAX returns a symbolic zero
            assert name == "dx" and not need_dx and not want.any()
            continue
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=_tolerance(dtype, want),
                                   err_msg=name)
    # the row of length 0 takes and gives nothing, its carries included
    dh0, dc0 = g_got[5:]
    assert not dh0[:, 2].any() and not dc0[:, 2].any()


def test_final_state_cotangents_matter():
    """Controls: dropping dhf and dcf, or the edge's c0 (its fg delta),
    changes the gradients by far more than the tolerance."""
    ops, carry, (dh, dhf, dcf) = _inputs("uni-f32")
    t = [torch.tensor(a) for a in ops]
    h0, c0 = map(torch.tensor, carry)
    lengths = torch.tensor(LENGTHS)
    h, c, g, _ = lstm_fwd_save_carry(*t, lengths, h0, c0, BIAS_MULT)
    args = (t[0], t[1], t[2], t[3], lengths, h, c, g)
    base = lstm_bwd_carry(*args, h0, c0, torch.tensor(dh),
                          torch.tensor(dhf), torch.tensor(dcf), BIAS_MULT)
    z = torch.zeros_like(h0)
    no_cts = lstm_bwd_carry(*args, h0, c0, torch.tensor(dh), z, z,
                            BIAS_MULT)
    no_c0 = lstm_bwd_carry(*args, h0, z, torch.tensor(dh), torch.tensor(dhf),
                           torch.tensor(dcf), BIAS_MULT)
    for other in (no_cts, no_c0):
        diff = max((a - b).abs().max().item() / max(1.0, b.abs().max().item())
                   for a, b in zip(other[1:], base[1:]))
        assert diff > 1e-3


def test_two_chained_blocks_equal_the_whole_sequence():
    """Two blocks chained through (hf, cf) equal one call on the whole
    sequence, outputs and every gradient through the chain, ascending and
    descending (tests/test_pallas_carry.py:61-104's check, on the port).
    Gradients within 1e-5 of each output's largest entry: the chain hands
    its cell-state terms on as dc0, a reassociation of the same sums."""
    d, h = 1, 6
    rng = np.random.RandomState(7)
    u = lambda *s: rng.uniform(-0.5, 0.5, s).astype(np.float32)  # noqa
    x = torch.tensor(rng.randn(2 * T, B, P).astype(np.float32))
    w = [torch.tensor(a, requires_grad=True)
         for a in (u(d, P, 4 * h), u(d, h, 4 * h), u(d, 3, h), u(d, 4 * h))]
    lengths = np.array([2 * T, 11, 0, 4, 2 * T], np.int32)
    dy = torch.tensor(rng.randn(2 * T, B, h).astype(np.float32))
    z = torch.zeros(1, B, h)
    for dir_offset in (0, 1):
        run = functools.partial(lstm_scan_fused_carry, bias_mult=BIAS_MULT,
                                dir_offset=dir_offset)

        def whole():
            y, (hf, cf) = run(x, *w, torch.tensor(lengths), z, z)
            return y, hf, cf

        def chained():
            blocks = [(0, T), (T, 2 * T)]
            if dir_offset:
                blocks.reverse()
            state, ys = (z, z), {}
            for lo, hi in blocks:
                bl = np.clip(lengths - lo, 0, hi - lo).astype(np.int32)
                ys[lo], state = run(x[lo:hi], *w, torch.tensor(bl), *state)
            return torch.cat([ys[0], ys[T]]), *state

        outs = [fn() for fn in (whole, chained)]
        for a, b in zip(*outs):
            np.testing.assert_allclose(a.detach().numpy(),
                                       b.detach().numpy(), rtol=0, atol=1e-6)
        grads = [torch.autograd.grad(
            (y * dy).sum() + hf.sum() + 0.5 * cf.sum(), w)
            for y, hf, cf in outs]
        for name, a, b in zip(("W_in", "W_rec", "peep", "b"), *grads):
            scale = max(1.0, b.abs().max().item())
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-5 * scale,
                                       err_msg=f"{name} dir {dir_offset}")


def test_zero_carry_equals_lstm_bwd_twin():
    """With zero carries and zero final-state cotangents the carry BPTT's
    twin is the plain BPTT's twin (both directions of a BLSTM), bit for
    bit, and dh0 = round(da) . W_rec^T of the last BPTT step."""
    ops, _, (dh, _, _) = _inputs("bi-f32")
    t = [torch.tensor(a) for a in ops]
    lengths = torch.tensor(LENGTHS)
    h, c, g = lstm_scan_reference(*t, lengths, BIAS_MULT, save=True)
    z = torch.zeros(2, B, 6)
    h2, c2, g2, _ = lstm_scan_carry_reference(*t, lengths, z, z, BIAS_MULT,
                                              save=True)
    assert torch.equal(h, h2) and torch.equal(c, c2) and torch.equal(g, g2)
    args = (t[0], t[1], t[2], t[3], lengths, h, c, g)
    plain = lstm_scan_bwd_reference(*args, torch.tensor(dh), BIAS_MULT)
    carry = lstm_scan_carry_bwd_reference(*args, z, z, torch.tensor(dh), z, z,
                                          BIAS_MULT)
    for a, b in zip(plain, carry):
        assert torch.equal(a, b)
    assert carry[5].abs().max() > 0  # the rows reaching t = 0 pass dh0 on


def test_step_mask_under_autograd_raises():
    """The backward takes prefix lengths only: a step mask under autograd
    raises, as the JAX package's carry VJP does; without autograd it
    runs."""
    ops, carry, _ = _inputs("uni-f32")
    ts = [torch.tensor(a, requires_grad=True) for a in ops + carry]
    mask = torch.ones(B, T)
    with pytest.raises(NotImplementedError, match="inference-only"):
        lstm_scan_fused_carry(*ts[:5], torch.tensor(LENGTHS), *ts[5:],
                              step_mask=mask)
    with torch.no_grad():
        lstm_scan_fused_carry(*ts[:5], torch.tensor(LENGTHS), *ts[5:],
                              step_mask=mask)


def test_cpu_runs_the_twins_and_counts_no_launch():
    before = (lstm_fwd_save_carry.launches, lstm_bwd_carry.launches,
              lstm_scan_fused_carry.launches)
    _port("uni-f32")
    assert (lstm_fwd_save_carry.launches, lstm_bwd_carry.launches,
            lstm_scan_fused_carry.launches) == before
