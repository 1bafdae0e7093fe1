"""The port's seven post-output losses and two correct counters
(lstm_rnn_tpu_torch/models/losses.py) against the JAX package's, values and
gradients (the reference's hand-written output errors, quirks included),
on the same numpy inputs made from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lstm_rnn_tpu.models import losses as jax_losses
from lstm_rnn_tpu_torch.models import losses

T, B, L = 5, 3, 4
LENGTHS = np.array([5, 2, 1])


def _data(name):
    rng = np.random.RandomState(len(name))
    pattypes = (np.arange(T)[:, None] < LENGTHS[None, :]).astype(np.int8)
    if name == "binary_classification":
        y = rng.uniform(0.05, 0.95, (T, B, 1))
        targets = rng.randint(0, 2, (T, B)).astype(np.int32)
    elif name == "multiclass_classification":
        y = rng.dirichlet(np.ones(L), (T, B))
        y[0, 0, 2] = 0.0  # p = 0 at a target: the REAL_MIN clamp
        targets = rng.randint(0, L, (T, B)).astype(np.int32)
        targets[0, 0] = 2
        targets[~pattypes.astype(bool)] = -1
    else:
        # ce: positive outputs, some tiny, so that the +-100 clamp bites
        y = rng.uniform(1e-3, 1.0, (T, B, L))
        y[1, 0, 1] = 1e-4
        width = 2 * L if name in ("weighted_sse", "weightedsse", "sse_mask",
                                     "wf") else L
        targets = rng.uniform(0.0, 1.0, (T, B, width))
    return y.astype(np.float32), targets.astype(
        np.float32 if targets.dtype.kind == "f" else np.int32), pattypes


@pytest.mark.parametrize("name", sorted(losses.LOSSES))
def test_loss_value_and_gradient_match_jax(name):
    y, targets, pattypes = _data(name)
    jfn, jkind = jax_losses.LOSSES[name]
    fn, kind = losses.LOSSES[name]
    assert kind == jkind
    want, jgrad = jax.value_and_grad(jfn)(jnp.asarray(y), jnp.asarray(targets),
                                          jnp.asarray(pattypes))
    yt = torch.tensor(y, requires_grad=True)
    got = fn(yt, torch.tensor(targets), torch.tensor(pattypes))
    (grad,) = torch.autograd.grad(got, yt, torch.tensor(0.5))
    # f32 sums in another order
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(grad.numpy(), 0.5 * np.asarray(jgrad),
                               rtol=1e-6, atol=1e-7)
    # padding frames get no gradient
    assert not grad.numpy()[~pattypes.astype(bool)].any()


@pytest.mark.parametrize("name", ["binary_classification",
                                  "multiclass_classification"])
def test_correct_counts_match_jax(name):
    y, targets, pattypes = _data(name)
    if name == "multiclass_classification":
        y[2, 0] = [0.1, 0.4, 0.1, 0.4]  # a tie: the first argmax counts
        targets[2, 0] = 1
        jfn, fn = (jax_losses.multiclass_correct_count,
                   losses.multiclass_correct_count)
    else:
        jfn, fn = (jax_losses.binary_correct_count,
                   losses.binary_correct_count)
    want = int(jfn(jnp.asarray(y), jnp.asarray(targets),
                   jnp.asarray(pattypes)))
    got = fn(torch.tensor(y), torch.tensor(targets), torch.tensor(pattypes))
    assert got.dtype == torch.int32 and int(got) == want
