"""--init_rng currennt in the port (lstm_rnn_tpu_torch/utils/rng_compat.py,
Network.init_params(init_rng=), the CLI flag) against the JAX package's:
the raw MT19937 stream, boost's uniform mapping, the networks it draws,
the normal-dist refusal and the CLI's initial weights, bit for bit."""

import json

import numpy as np
import pytest

from lstm_rnn_tpu import cli as jax_cli
from lstm_rnn_tpu.network import Network as JaxNetwork
from lstm_rnn_tpu.utils import rng_compat as jax_rng
from lstm_rnn_tpu_torch import cli
from lstm_rnn_tpu_torch import io_currennt as ioc
from lstm_rnn_tpu_torch.network import Network
from lstm_rnn_tpu_torch.utils import rng_compat
from tests.test_data import _write_classification_nc

# every trainable kind the stream fills: a BLSTM, an LSTM, a tanh layer
# and the softmax
LAYERS = [
    {"name": "input", "type": "input", "size": 3},
    {"name": "l1", "type": "blstm", "size": 6, "bias": 1.0},
    {"name": "l2", "type": "lstm", "size": 5, "bias": 1.0},
    {"name": "ff", "type": "feedforward_tanh", "size": 4, "bias": 1.0},
    {"name": "output", "type": "softmax", "size": 5, "bias": 1.0},
    {"name": "postoutput", "type": "multiclass_classification", "size": 5},
]


@pytest.mark.parametrize("seed", [1, 5489, 4711, 4294967295])
def test_mt19937_raw_matches_jax_module(seed):
    """The raw tempered words, drawn in pieces that cross the 624-word
    twist, element for element."""
    got, want = rng_compat.MT19937(seed), jax_rng.MT19937(seed)
    for n in (1, 622, 3, 1500, 624):
        np.testing.assert_array_equal(got.raw(n), want.raw(n))
    assert got.raw1() == want.raw1()


@pytest.mark.parametrize("lo,hi", [(-0.1, 0.1), (0.0, 1.0), (-0.5, 0.25)])
def test_uniform_matches_jax_module(lo, hi):
    got = rng_compat.CurrenntInitStream(42)
    want = jax_rng.CurrenntInitStream(42)
    for n in (7, 4096, 700):
        a, b = got.uniform(n, lo, hi), want.uniform(n, lo, hi)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def _both(layers, weights=None, **kw):
    port, jax_net = Network(layers, weights), JaxNetwork(layers, weights)
    port.init_params(7, init_rng="currennt", **kw)
    jax_net.init_params(7, init_rng="currennt", **kw)
    return port.params, {n: {k: np.asarray(v) for k, v in layer.items()}
                         for n, layer in jax_net.params.items()}


def _assert_trees_equal(got, want):
    assert got.keys() == want.keys()
    for n in want:
        assert got[n].keys() == want[n].keys()
        for k in want[n]:
            assert got[n][k].dtype == want[n][k].dtype == np.float32
            np.testing.assert_array_equal(got[n][k], want[n][k],
                                          err_msg=f"{n}/{k}")


@pytest.mark.parametrize("lo,hi", [(-0.1, 0.1), (-0.3, 0.2)])
def test_init_params_currennt_matches_jax(lo, hi):
    got, want = _both(LAYERS, uniform_min=lo, uniform_max=hi)
    _assert_trees_equal(got, want)
    # the stream is one engine: the first layer's flat vector is the
    # stream's first words, in [input | bias | internal] order
    flat = np.concatenate(ioc.lstm_to_flat(got["l1"]))
    stream = rng_compat.CurrenntInitStream(7).uniform(flat.size, lo, hi)
    np.testing.assert_array_equal(flat, stream)


def test_init_params_currennt_skips_weighted_layers():
    """A layer read from the weights section takes no draw: the next
    layer draws where the first one's draws would have begun, as in the
    JAX package."""
    first = Network(LAYERS)
    first.init_params(7, init_rng="currennt")
    weights = ioc.weights_section_from_params(
        [dict(lc) for lc in LAYERS], {"l1": first.params["l1"]})
    got, want = _both(LAYERS, weights)
    _assert_trees_equal(got, want)
    np.testing.assert_array_equal(got["l1"]["W_in"], first.params["l1"]["W_in"])
    np.testing.assert_array_equal(
        np.concatenate(ioc.lstm_to_flat(got["l2"]))[:8],
        rng_compat.CurrenntInitStream(7).uniform(8, -0.1, 0.1))


def test_init_currennt_normal_refused_with_jax_message():
    """dist normal has no reference stream to replay: both packages raise
    the same ValueError, and only when some layer needs a draw."""
    msgs = []
    for net in (Network(LAYERS), JaxNetwork(LAYERS)):
        with pytest.raises(ValueError) as e:
            net.init_params(7, dist="normal", init_rng="currennt")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert "--weights_dist uniform or --init_rng numpy" in msgs[0]
    # a fully weighted network draws nothing and is accepted
    full = Network(LAYERS)
    full.init_params(3)
    weights = ioc.weights_section_from_params([dict(lc) for lc in LAYERS],
                                              full.params)
    net = Network(LAYERS, weights)
    net.init_params(7, dist="normal", init_rng="currennt")
    np.testing.assert_array_equal(net.params["ff"]["W"], full.params["ff"]["W"])


def test_cli_init_rng_currennt_matches_jax_cli(tmp_path, monkeypatch):
    """`--init_rng currennt --learning_rate 0` saves the initial weights:
    the port's CLI and the JAX CLI write the same network, bit for bit,
    and it is the host replay of the stream."""
    nc = str(tmp_path / "t.nc")
    _write_classification_nc(nc, [6, 5, 4], in_size=3, num_labels=5, seed=2)
    net = str(tmp_path / "net.jsn")
    with open(net, "w") as f:
        json.dump({"layers": LAYERS}, f)
    docs = {}
    for label, main in (("jax", jax_cli.main), ("port", cli.main)):
        d = tmp_path / label
        d.mkdir()
        monkeypatch.chdir(d)
        assert main(["--network", net, "--train", "true", "--train_file", nc,
                     "--init_rng", "currennt", "--learning_rate", "0",
                     "--max_epochs", "1", "--parallel_sequences", "2",
                     "--random_seed", "4711", "--device", "cpu"]) == 0
        with open(d / "trained_network.jsn") as f:
            docs[label] = json.load(f)["weights"]
    assert docs["port"] == docs["jax"]
    replay = Network(LAYERS)
    replay.init_params(4711, init_rng="currennt")
    flat = ioc.weights_section_from_params([dict(lc) for lc in LAYERS],
                                           replay.params)
    for name, sec in flat.items():
        for part, values in sec.items():
            np.testing.assert_array_equal(
                np.asarray(docs["port"][name][part], np.float32),
                np.asarray(values, np.float32), err_msg=f"{name}/{part}")
