"""The port's LSTM forward (lstm_rnn_tpu_torch.models.lstm) against the JAX
package's, on the same numpy inputs made from a seed.

On the CPU the port runs the kernel's plain twin (backend "auto"/"pallas")
or the scan path ("scan"). The JAX side runs its Pallas kernel in interpret
mode ("pallas_interpret", as tests/test_pallas_cell.py does) or its
lax.scan path. The Hopper kernel itself is held against the twin on the
card, in tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lstm_rnn_tpu.models.lstm import lstm_forward as jax_lstm_forward
from lstm_rnn_tpu_torch.models.lstm import lstm_forward
from lstm_rnn_tpu_torch.ops.lstm_cell import lstm_scan_fused

# (D, H, P, compute dtype): H on both sides of 128 (the JAX kernel pads
# cells to 128 lanes; the port does not pad), odd P
CASES = {
    "uni-h5-f32": (1, 5, 7, "float32"),
    "bi-h5-f32": (2, 5, 7, "float32"),
    "bi-h130-f32": (2, 130, 131, "float32"),
    "uni-h130-bf16": (1, 130, 3, "bfloat16"),
    "bi-h5-bf16": (2, 5, 7, "bfloat16"),
}
T, B, BIAS_MULT = 6, 3, 0.7
LENGTHS = np.array([6, 3, 1])  # ragged, including 1 and T


def _inputs(case):
    d, h, p, _ = CASES[case]
    rng = np.random.RandomState(sorted(CASES).index(case))
    params = {
        "W_in": rng.uniform(-0.5, 0.5, (d, p, 4, h)),
        "W_rec": rng.uniform(-0.5, 0.5, (d, h, 4, h)),
        "b": rng.uniform(-0.5, 0.5, (d, 4, h)),
        "peep": rng.uniform(-0.5, 0.5, (d, 3, h)),
    }
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.randn(T, B, p).astype(np.float32)
    pattypes = (np.arange(T)[:, None] < LENGTHS[None, :]).astype(np.int8)
    return params, x, pattypes


@functools.lru_cache(maxsize=None)
def _jax_out(case, backend):
    d, _, _, dtype = CASES[case]
    params, x, pattypes = _inputs(case)
    y = jax_lstm_forward({k: jnp.asarray(v) for k, v in params.items()},
                         jnp.asarray(x), jnp.asarray(pattypes), BIAS_MULT,
                         d == 2, backend=backend,
                         compute_dtype=jnp.dtype(dtype))
    return np.asarray(y)


def _port_out(case, backend):
    d, _, _, dtype = CASES[case]
    params, x, pattypes = _inputs(case)
    with torch.inference_mode():
        y = lstm_forward({k: torch.from_numpy(v) for k, v in params.items()},
                         torch.from_numpy(x), torch.from_numpy(pattypes),
                         BIAS_MULT, d == 2, backend=backend,
                         compute_dtype=getattr(torch, dtype))
    assert y.dtype == torch.float32
    return y.numpy()


def _tolerance(dtype, jax_backend):
    if dtype == "float32":
        # true-f32 products summed in another order, over <= 6 steps
        return 1e-5
    if jax_backend == "pallas_interpret":
        # same rounding points; a different sum order can move h across a
        # bf16 rounding boundary: two bf16 ulps at |h| < 1
        return 8e-3
    # the JAX scan path keeps the exact CURRENNT forms and an f32 output
    # in bf16 mode where the kernel (and its twins) use plain sigma/tanh
    # and store h in bf16 (2^-8 relative): a few bf16 ulps
    return 2e-2


@pytest.mark.parametrize("port_backend", ["auto", "scan"])
@pytest.mark.parametrize("jax_backend", ["pallas_interpret", "scan"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_lstm_forward_matches_jax(case, jax_backend, port_backend):
    want = _jax_out(case, jax_backend)
    got = _port_out(case, port_backend)
    assert got.shape == want.shape
    # padding slots are exactly zero in both
    assert not got[LENGTHS[2]:, 2].any()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=_tolerance(CASES[case][3], jax_backend))


@pytest.mark.parametrize("case", ["bi-h5-f32", "bi-h5-bf16"])
def test_twins_agree(case):
    """The kernel-layout twin and the scan path are two formulations of
    the same arithmetic: with one rounding sequence they agree to f32
    round-off, in either mode."""
    np.testing.assert_allclose(_port_out(case, "auto"),
                               _port_out(case, "scan"), rtol=0, atol=1e-6)


def _fused_args(requires_grad=False):
    rng = np.random.RandomState(0)
    d, h, p = 2, 3, 4
    t = lambda a: torch.tensor(a, dtype=torch.float32,  # noqa: E731
                               requires_grad=requires_grad)
    return (t(rng.randn(T, B, p)), t(rng.randn(d, p, 4 * h)),
            t(rng.randn(d, h, 4 * h)), t(rng.randn(d, 3, h)),
            t(rng.randn(d, 4 * h)), torch.tensor(LENGTHS, dtype=torch.int32))


def test_fused_is_forward_only():
    """Without autograd recording (inference mode or no_grad, even on
    tensors that require gradients) the layer runs the inference forward:
    no graph, no residuals. With it, the output carries the BPTT backward
    (tests/test_torch_lstm_grad.py holds its values)."""
    args = _fused_args(requires_grad=True)
    with torch.no_grad():
        assert lstm_scan_fused(*args).grad_fn is None
    with torch.inference_mode():
        assert lstm_scan_fused(*args).grad_fn is None
    out = lstm_scan_fused(*args)
    assert type(out.grad_fn).__name__ == "LstmScanFusedBackward"


@pytest.mark.parametrize("arg, shape", [(1, (2, 5, 12)), (2, (2, 3, 11)),
                                        (3, (2, 2, 3)), (4, (1, 12)),
                                        (5, (4,))])
def test_fused_rejects_bad_shapes(arg, shape):
    args = list(_fused_args())
    args[arg] = torch.zeros(shape, dtype=args[arg].dtype)
    with pytest.raises(ValueError, match="shape"):
        lstm_scan_fused(*args)


def test_fused_cpu_runs_the_twin_and_counts_no_launch():
    before = lstm_scan_fused.launches
    out = lstm_scan_fused(*_fused_args())
    assert out.shape == (T, B, 2 * 3) and out.dtype == torch.float32
    assert lstm_scan_fused.launches == before
