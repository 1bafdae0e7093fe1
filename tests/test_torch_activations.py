"""The port's activations (lstm_rnn_tpu_torch.ops.activations) against the
JAX package's, at and around the reference's clamps +-EXP_LIMIT and
LOG_ZERO, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lstm_rnn_tpu.ops import activations as ja
from lstm_rnn_tpu_torch.ops import activations as ta

_E = np.float32(ta.EXP_LIMIT)
# points on both sides of every clamp, the clamps themselves, and ordinary
# values; float32 like every activation in the port
_X = np.array([
    -np.inf, -3e38, ta.LOG_ZERO, np.nextafter(np.float32(ta.LOG_ZERO), 0),
    -1e29, -2 * _E, -_E - 1, np.nextafter(-_E, -np.inf), -_E,
    np.nextafter(-_E, 0), -_E / 2, -44.5, -20.0, -3.0, -1.0, -1e-3, -1e-30,
    0.0, 1e-30, 1e-3, 0.5, 1.0, 3.0, 20.0, 44.5, _E / 2,
    np.nextafter(_E, 0), _E, np.nextafter(_E, np.inf), _E + 1, 2 * _E,
    1e29, 3e38, np.inf], dtype=np.float32)

_NAMES = ["logistic", "tanh2", "safe_exp", "maxmin1", "maxmin2", "max2min0",
          "identity"]


@pytest.mark.parametrize("name", _NAMES)
def test_matches_jax_at_the_clamps(name):
    want = np.asarray(getattr(ja, name)(jnp.asarray(_X)))
    got = getattr(ta, name)(torch.from_numpy(_X)).numpy()
    assert got.dtype == np.float32
    # the saturation branches must agree exactly (same 0, 1, REAL_MAX);
    # elsewhere torch's and XLA's exp may differ by an ulp or two (rtol),
    # and XLA on the CPU flushes denormal results to 0 where torch keeps
    # them (atol: below the smallest normal float32)
    np.testing.assert_allclose(got, want, rtol=4e-7, atol=ta.REAL_MIN)


def test_clamp_values_are_the_references():
    x = torch.tensor([ta.EXP_LIMIT, -ta.EXP_LIMIT, ta.LOG_ZERO, 100.0],
                     dtype=torch.float32)
    assert ta.logistic(x).tolist()[:2] == [1.0, 0.0]
    assert ta.tanh2(x).tolist()[:2] == [1.0, -1.0]
    e = ta.safe_exp(x)
    assert e[0].item() == np.float32(ta.REAL_MAX)
    assert e[2].item() == 0.0
    assert e[3].item() == np.float32(ta.REAL_MAX)


def test_activation_table_matches():
    assert sorted(ta.ACTIVATIONS) == sorted(ja.ACTIVATIONS)
    for k, f in ta.ACTIVATIONS.items():
        assert f.__name__ == ja.ACTIVATIONS[k].__name__
