"""The port's fused classification tail (ops/softmax_ce.py) against the JAX
package's softmax_ce_proj_fused with its Pallas kernels in interpret mode,
on the same numpy inputs made from a seed.

On the CPU the port runs the twins of its two kernels. The JAX kernels
want 128-lane widths, so the JAX side gets S and P zero-padded to 128
(padded logit lanes are ignored by construction, zero h columns and W rows
add nothing); the port takes the exact widths. The Hopper kernels are held
against the twins on the card (tests/test_torch_kernels_cuda.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lstm_rnn_tpu.ops.softmax_ce import _proj_fwd_impl
from lstm_rnn_tpu.ops.softmax_ce import softmax_ce_proj_fused as jax_tail
from lstm_rnn_tpu_torch.ops.softmax_ce import (softmax_ce_proj_bwd,
                                               softmax_ce_proj_fused,
                                               softmax_ce_proj_fwd)

N, P, PP = 64, 100, 128
BIAS_MULT, G = 0.8, 0.37  # G: the loss cotangent
DUMMY = (5, 17, 40)  # rows with target -1
CASES = [(5, "float32"), (5, "bfloat16"), (183, "float32"),
         (183, "bfloat16")]


def _inputs(S):
    rng = np.random.RandomState(S)
    h = (0.5 * rng.randn(N, P)).astype(np.float32)
    w = rng.uniform(-0.3, 0.3, (P, S)).astype(np.float32)
    b = rng.uniform(-0.3, 0.3, S).astype(np.float32)
    tc = rng.randint(0, S, N).astype(np.int32)
    tc[list(DUMMY)] = -1
    # rows 10 and 11 see only the bias, whose maximum is tied at classes 1
    # and 3: the first argmax (1) counts for row 11, not for row 10
    h[10:12] = 0.0
    b[1] = b[3] = b.max() + 1.0
    tc[10], tc[11] = 3, 1
    return h, w, b, tc


@functools.lru_cache(maxsize=None)
def _jax(S, dtype):
    h, w, b, tc = _inputs(S)
    sp = -(-S // 128) * 128
    hp = np.pad(h, ((0, 0), (0, PP - P)))
    wp = np.pad(w, ((0, PP - P), (0, sp - S)))
    bp = np.pad(b, (0, sp - S))
    t2 = jnp.asarray(tc[:, None])
    dt = jnp.dtype(dtype)
    f = functools.partial(jax_tail, targets=t2, S=S, bias_mult=BIAS_MULT,
                          interpret=True, compute_dtype=dt)
    loss, vjp = jax.vjp(lambda *a: f(*a)[0], *map(jnp.asarray, (hp, wp, bp)))
    cnt = f(*map(jnp.asarray, (hp, wp, bp)))[1]
    dh, dw, db = vjp(jnp.asarray(G, jnp.float32))
    (_, _), (p, *_) = _proj_fwd_impl(jnp.asarray(hp), jnp.asarray(wp),
                                     jnp.asarray(bp), t2, S, BIAS_MULT,
                                     True, dt)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return (float(loss), int(cnt), f32(p)[:, :S], f32(dh)[:, :P],
            f32(dw)[:P, :S], f32(db)[:S])


def _tolerance(dtype, ref):
    if dtype == "float32":
        # true f32 on both sides, sums in another order
        return 1e-5 * max(1.0, float(np.abs(ref).max()))
    # p and dz are stored in bf16: a value rounded to the other side of a
    # bf16 boundary moves the products by up to one bf16 ulp (2^-8) of the
    # largest entry
    return 2.0 ** -8 * max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("S, dtype", CASES)
def test_tail_matches_jax(S, dtype):
    loss_j, cnt_j, _, dh_j, dw_j, db_j = _jax(S, dtype)
    h, w, b, tc = _inputs(S)
    ts = [torch.tensor(a, requires_grad=True) for a in (h, w, b)]
    loss, cnt = softmax_ce_proj_fused(*ts, torch.tensor(tc), S, BIAS_MULT,
                                      getattr(torch, dtype))
    assert loss.dtype == torch.float32 and cnt.dtype == torch.int32
    # f32 loss over 61 rows: sum order; bf16 as f32 (p is f32 in the loss)
    np.testing.assert_allclose(float(loss.detach()), loss_j, rtol=1e-5)
    assert int(cnt) == cnt_j
    dh, dw, db = torch.autograd.grad(loss, ts, torch.tensor(G))
    for name, got, want in (("dh", dh, dh_j), ("dW", dw, dw_j),
                            ("db", db, db_j)):
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=_tolerance(dtype, want),
                                   err_msg=name)
    assert not dh[list(DUMMY)].any()  # dummy rows get no gradient


@pytest.mark.parametrize("S, dtype", CASES)
def test_want_p_on_and_off(S, dtype):
    loss_j, cnt_j, p_j, _, _, _ = _jax(S, dtype)
    h, w, b, tc = (torch.tensor(a) for a in _inputs(S))
    dt = getattr(torch, dtype)
    loss, cnt, p = softmax_ce_proj_fwd(h, w, b, tc, BIAS_MULT, dt)
    assert p.dtype == dt and p.shape == (N, S)
    np.testing.assert_allclose(p.float().numpy(), p_j, rtol=0,
                               atol=_tolerance(dtype, p_j))
    # the tie row: classes 1 and 3 hold the same probability
    assert p[10, 1] == p[10, 3] == p[10].max()
    loss0, cnt0, p0 = softmax_ce_proj_fwd(h, w, b, tc, BIAS_MULT, dt,
                                          want_p=False)
    assert p0 is None and float(loss0) == float(loss)
    assert int(cnt0) == int(cnt) == cnt_j
    # without autograd recording the fused tail runs the forward alone
    with torch.no_grad():
        loss1, cnt1 = softmax_ce_proj_fused(h, w, b, tc, S, BIAS_MULT, dt)
    assert float(loss1) == float(loss) and int(cnt1) == cnt_j


def test_twins_count_no_launch():
    h, w, b, tc = (torch.tensor(a) for a in _inputs(5))
    before = (softmax_ce_proj_fwd.launches, softmax_ce_proj_bwd.launches)
    _, _, p = softmax_ce_proj_fwd(h, w, b, tc)
    softmax_ce_proj_bwd(p, h, w, tc, torch.tensor(1.0))
    assert (softmax_ce_proj_fwd.launches,
            softmax_ce_proj_bwd.launches) == before
