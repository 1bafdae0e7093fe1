"""The port's LSTM gradients against the JAX package's and the float64
oracle, on the same numpy inputs made from a seed.

On the CPU the port's autograd Function (LstmScanFused) runs the twins of
its two kernels: the training forward (lstm_scan_reference(save=True)) and
the BPTT (lstm_scan_bwd_reference). They are held against `jax.vjp` of the
JAX package's lstm_scan_fused with its Pallas kernels in interpret mode, at
the kernel's own test shapes (tests/test_pallas_cell.py). The scan route's
autograd (and the twins again, at odd widths) is held against the float64
oracle's hand-written BPTT (tests/oracle.py). The Hopper kernels themselves
are held against the twins on the card (tests/test_torch_kernels_cuda.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lstm_rnn_tpu.ops.lstm_cell import lstm_scan_fused as jax_lstm_scan_fused
from lstm_rnn_tpu_torch.models.lstm import lstm_forward
from lstm_rnn_tpu_torch.ops.lstm_cell import (lstm_bwd, lstm_fwd_save,
                                              lstm_scan_fused)
from tests import oracle

T, B, H, P = 12, 8, 128, 128
BIAS_MULT = 0.7
# ragged, including 0 and T
LENGTHS = np.array([12, 5, 0, 12, 1, 7, 3, 11], np.int32)
# (D, clip, need_dx, dtype)
CASES = {
    "bi-f32": (2, True, True, "float32"),
    "uni-f32": (1, True, True, "float32"),
    "bi-noclip-f32": (2, False, True, "float32"),
    "bi-nodx-f32": (2, True, False, "float32"),
    "bi-bf16": (2, True, True, "bfloat16"),
    "uni-noclip-nodx-bf16": (1, False, False, "bfloat16"),
}
NAMES = ["dx", "dW_in", "dW_rec", "dpeep", "dbias"]


def _inputs(case):
    d = CASES[case][0]
    rng = np.random.RandomState(sorted(CASES).index(case))
    u = lambda *s: rng.uniform(-0.1, 0.1, s).astype(np.float32)  # noqa: E731
    x = rng.randn(T, B, P).astype(np.float32)
    # a large output error drives some gate deltas past +-1, so the clip
    # matters (test_clip_is_exercised)
    dh = (20.0 * rng.randn(T, B, d * H)).astype(np.float32)
    return (x, u(d, P, 4 * H), u(d, H, 4 * H), u(d, 3, H), u(d, 4 * H)), dh


@functools.lru_cache(maxsize=None)
def _jax(case):
    _, clip, need_dx, dtype = CASES[case]
    args, dh = _inputs(case)
    f = functools.partial(jax_lstm_scan_fused, lengths=jnp.asarray(LENGTHS),
                          bias_mult=BIAS_MULT, clip=clip, interpret=True,
                          compute_dtype=jnp.dtype(dtype), need_dx=need_dx)
    h, vjp = jax.vjp(lambda *a: f(*a), *map(jnp.asarray, args))
    grads = vjp(jnp.asarray(dh).astype(h.dtype))
    return (np.asarray(h, np.float32),
            [np.asarray(g, np.float32) for g in grads])


def _port(case, clip=None):
    _, clip_c, need_dx, dtype = CASES[case]
    args, dh = _inputs(case)
    ts = [torch.tensor(a, requires_grad=need_dx or i > 0)
          for i, a in enumerate(args)]
    h = lstm_scan_fused(*ts, torch.tensor(LENGTHS), BIAS_MULT,
                        getattr(torch, dtype),
                        clip_c if clip is None else clip)
    wanted = ts if need_dx else ts[1:]
    grads = torch.autograd.grad(h, wanted, torch.tensor(dh).to(h.dtype))
    grads = ([None] if not need_dx else []) + [g.numpy() for g in grads]
    return h.detach().float().numpy(), grads


def _tolerance(dtype, ref):
    if dtype == "float32":
        # true f32 on both sides, sums in another order: ~1e-5 relative
        return 1e-5 * max(1.0, float(np.abs(ref).max()))
    # bf16 stores h, the gates and the deltas: where the two sum orders put
    # an f32 value on the other side of a bf16 rounding boundary, every
    # product downstream of it moves by up to one bf16 ulp (2^-8) of the
    # largest entry
    return 2.0 ** -8 * max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("case", sorted(CASES))
def test_lstm_grad_matches_jax_vjp(case):
    _, _, need_dx, dtype = CASES[case]
    h_want, g_want = _jax(case)
    h_got, g_got = _port(case)
    np.testing.assert_allclose(h_got, h_want, rtol=0,
                               atol=_tolerance(dtype, h_want))
    # rows of length 0 produce and receive nothing
    assert not h_got[:, 2].any()
    for name, got, want in zip(NAMES, g_got, g_want):
        if got is None:  # need_dx=False: the first layer's dx is skipped
            assert name == "dx" and not want.any()
            continue
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=_tolerance(dtype, want),
                                   err_msg=name)
        if name == "dx":
            assert not got[:, 2].any()


def test_clip_is_exercised():
    """The inputs drive deltas past +-1: clipping changes the gradients."""
    _, clipped = _port("bi-f32")
    _, unclipped = _port("bi-f32", clip=False)
    assert np.abs(clipped[2] - unclipped[2]).max() > 1e-2


def test_bwd_twin_counts_no_launch():
    args, dh = _inputs("uni-f32")
    ts = [torch.tensor(a) for a in args] + [torch.tensor(LENGTHS)]
    before = (lstm_fwd_save.launches, lstm_bwd.launches)
    h, c, gates = lstm_fwd_save(*ts)
    assert c.shape == (1, T, B, H) and gates.shape == (1, T, B, 4 * H)
    # residuals are zero at padding
    assert not c[0, 5:, 1].any() and not gates[0, 5:, 1].any()
    lstm_bwd(ts[0], ts[1], ts[2], ts[3], ts[5], h, c, gates,
             torch.tensor(dh))
    assert (lstm_fwd_save.launches, lstm_bwd.launches) == before


# ---------------------------------------------------------------- oracle
# narrow widths (H = 5, odd P) against the float64 oracle's hand-written
# BPTT (LstmLayer.cu:190-512 in NumPy): the scan route by autograd, and the
# kernel route's twins
OT, OB, OP, OH = 7, 3, 3, 5
OLENGTHS = np.array([7, 4, 1])


@pytest.mark.parametrize("backend", ["scan", "auto"])
@pytest.mark.parametrize("bidirectional", [False, True])
def test_lstm_grad_matches_oracle(backend, bidirectional):
    d = 2 if bidirectional else 1
    rng = np.random.RandomState(3 + d)
    params = {"W_in": rng.uniform(-0.5, 0.5, (d, OP, 4, OH)),
              "W_rec": rng.uniform(-0.5, 0.5, (d, OH, 4, OH)),
              "b": rng.uniform(-0.5, 0.5, (d, 4, OH)),
              "peep": rng.uniform(-0.5, 0.5, (d, 3, OH))}
    x = rng.randn(OT, OB, OP)
    pattypes = (np.arange(OT)[:, None] < OLENGTHS[None, :]).astype(np.int8)
    # large enough that some deltas clip
    err = 5.0 * rng.randn(OT, OB, d * OH)
    want_dx, want = oracle.lstm_backward(params, x, pattypes, BIAS_MULT,
                                         bidirectional, err)
    pt = {k: torch.tensor(v, dtype=torch.float32, requires_grad=True)
          for k, v in params.items()}
    xt = torch.tensor(x, dtype=torch.float32, requires_grad=True)
    y = lstm_forward(pt, xt, torch.tensor(pattypes), BIAS_MULT,
                     bidirectional, backend=backend)
    np.testing.assert_allclose(
        y.detach().numpy(),
        oracle.lstm(params, x, pattypes, BIAS_MULT, bidirectional),
        rtol=0, atol=1e-5)
    keys = sorted(pt)
    grads = torch.autograd.grad(y, [xt] + [pt[k] for k in keys],
                                torch.tensor(err, dtype=torch.float32))
    # f32 against f64 over 7 steps: ~1e-6 relative; 1e-5 of the largest
    np.testing.assert_allclose(grads[0].numpy(), want_dx, rtol=0,
                               atol=1e-5 * np.abs(want_dx).max())
    for k, g in zip(keys, grads[1:]):
        w = want[k].reshape(g.shape)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(w).max()),
                                   err_msg=k)
