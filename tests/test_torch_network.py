"""The port's Network (lstm_rnn_tpu_torch.network) and JSON interop against
the JAX package's: the same network JSON reads into bit-identical arrays,
the same seed draws the same initial weights, and `apply` on a 2-BLSTM
network gives the same posteriors on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lstm_rnn_tpu import io_currennt as jax_ioc
from lstm_rnn_tpu.network import Network as JaxNetwork
from lstm_rnn_tpu_torch import io_currennt as ioc
from lstm_rnn_tpu_torch.models.flagship import timit_dblstm_layers
from lstm_rnn_tpu_torch.network import Network, params_from_numpy


def _layers():
    """input(5) -> blstm(6) -> blstm(8) -> softmax(4) -> classification:
    two BLSTM layers, odd input width, H = 3 and 4 per direction."""
    return timit_dblstm_layers(input_size=5, hidden=6, depth=1,
                               num_states=4)[:2] + [
        {"name": "blstm_b", "type": "blstm", "size": 8, "bias": 0.5},
        {"name": "output", "type": "softmax", "size": 4, "bias": 1.0},
        {"name": "postoutput", "type": "multiclass_classification",
         "size": 4}]


def _assert_trees_identical(a, b):
    assert sorted(a) == sorted(b)
    for name in a:
        assert sorted(a[name]) == sorted(b[name])
        for k in a[name]:
            x, y = np.asarray(a[name][k]), np.asarray(b[name][k])
            assert x.dtype == y.dtype == np.float32, (name, k)
            np.testing.assert_array_equal(x, y, err_msg=f"{name}/{k}")


def test_init_params_draws_the_jax_weights():
    net, jnet = Network(_layers()), JaxNetwork(_layers())
    net.init_params(1234)
    jnet.init_params(1234)
    _assert_trees_identical(net.params, jnet.params)


def test_json_reads_bit_identical(tmp_path):
    jnet = JaxNetwork(_layers())
    jnet.init_params(7)
    path = str(tmp_path / "net.jsn")
    jnet.save(path)
    doc = jax_ioc.load_network_json(path)
    _assert_trees_identical(
        ioc.params_from_weights_section(doc["layers"], doc["weights"]),
        jax_ioc.params_from_weights_section(doc["layers"], doc["weights"]))
    _assert_trees_identical(Network.from_json_file(path).params,
                            JaxNetwork.from_json_file(path).params)


def test_save_writes_the_jax_packages_json(tmp_path):
    net = Network(_layers())
    net.init_params(3)
    jnet = JaxNetwork(_layers())
    jnet.init_params(3)
    net.save(str(tmp_path / "port.jsn"))
    jnet.save(str(tmp_path / "jax.jsn"))
    assert ((tmp_path / "port.jsn").read_text()
            == (tmp_path / "jax.jsn").read_text())


def test_params_from_numpy_keeps_layout():
    net = Network(_layers())
    net.init_params(5)
    t = params_from_numpy(net.params, "cpu")
    for name, layer in net.params.items():
        for k, v in layer.items():
            assert t[name][k].dtype == torch.float32
            assert t[name][k].is_contiguous()
            np.testing.assert_array_equal(t[name][k].numpy(), v)


@pytest.mark.parametrize("dtype, jax_backend, tol", [
    # true f32 on both sides, sums in another order
    ("float32", "auto", 1e-5),
    # bf16 operands: the JAX scan path keeps the exact CURRENNT forms and
    # f32 hidden outputs where the port's kernel path uses plain
    # sigma/tanh and bf16 h (test_torch_lstm holds each layer against the
    # JAX kernel's own rounding); a few bf16 ulps through two layers
    ("bfloat16", "auto", 2e-2),
])
def test_apply_matches_jax(dtype, jax_backend, tol):
    rng = np.random.RandomState(11)
    t, b = 7, 3
    lengths = np.array([7, 4, 1])
    x = rng.randn(t, b, 5).astype(np.float32)
    pt = (np.arange(t)[:, None] < lengths[None, :]).astype(np.int8)
    jnet = JaxNetwork(_layers(), backend=jax_backend, compute_dtype=dtype)
    jnet.init_params(21)
    want = np.asarray(jnet.apply(jnet.params, jnp.asarray(x),
                                 jnp.asarray(pt)))
    net = Network(_layers(), compute_dtype=dtype)
    net.init_params(21)
    with torch.inference_mode():
        got = net.apply(net.device_params("cpu"), torch.from_numpy(x),
                        torch.from_numpy(pt)).numpy()
    assert got.shape == (t, b, 4)
    valid = pt.astype(bool)
    np.testing.assert_allclose(got[valid].sum(-1), 1.0, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[valid], want[valid], rtol=0, atol=tol)


def test_topology_validation_matches_jax():
    bad = [
        _layers()[1:],                                   # no input layer
        _layers()[:-1],                                  # no post-output
        _layers()[:2] + [dict(_layers()[2], size=7)] + _layers()[3:],
        _layers()[:3] + [dict(_layers()[3], type="nope")] + _layers()[4:],
    ]
    for layers in bad:
        with pytest.raises(ValueError) as e_jax:
            JaxNetwork(layers)
        with pytest.raises(ValueError) as e_port:
            Network(layers)
        assert str(e_port.value) == str(e_jax.value)
