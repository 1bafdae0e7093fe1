"""The LVCSR slice of the port on the CPU: the recipe's builder against the
JAX package's, and a port Trainer whose softmax is too wide for the
projection tail (K3), so that it trains through the wide tail's twins
(K4), against the JAX Trainer on its wide Pallas kernels in interpret
mode (the padded pipeline, as tests/test_softmax_ce.py's
test_wide_tail_through_trainer engages them).
"""

import numpy as np
import pytest

from lstm_rnn_tpu.data.dataset import DataSet as JaxDataSet
from lstm_rnn_tpu.models.flagship import build_lvcsr_network as jax_lvcsr
from lstm_rnn_tpu.network import Network as JaxNetwork
from lstm_rnn_tpu.trainer import Trainer as JaxTrainer
from lstm_rnn_tpu_torch import network as network_mod
from lstm_rnn_tpu_torch.data.dataset import DataSet
from lstm_rnn_tpu_torch.models.flagship import build_lvcsr_network
from lstm_rnn_tpu_torch.network import Network
from lstm_rnn_tpu_torch.trainer import Trainer
from tests.test_data import _write_classification_nc

S = 4200
LAYERS = [
    {"name": "input", "type": "input", "size": 3},
    {"name": "l1", "type": "blstm", "size": 4, "bias": 1.0},
    {"name": "output", "type": "softmax", "size": S, "bias": 1.0},
    {"name": "postoutput", "type": "multiclass_classification", "size": S},
]


def test_build_lvcsr_network_matches_jax():
    net, want = build_lvcsr_network(seed=9), jax_lvcsr(seed=9)
    assert net.layers_json() == want.layers_json()
    assert [s.size for s in net.specs] == [117, 250, 250, 250, 250, 250,
                                           10112, 10112]
    assert net.params.keys() == want.params.keys()
    for name, layer in want.params.items():
        for k, v in layer.items():
            np.testing.assert_array_equal(net.params[name][k],
                                          np.asarray(v), err_msg=name + k)


def test_wide_trainer_matches_jax_wide_kernels(tmp_path, monkeypatch):
    nc = str(tmp_path / "t.nc")
    _write_classification_nc(nc, [10, 8, 12, 9], in_size=3, num_labels=S,
                             seed=3)

    jds = JaxDataSet([nc], parallel_sequences=2, sort_by_length=True,
                     prefetch=False)
    jnet = JaxNetwork(LAYERS, backend="pallas_interpret")
    jnet.init_params(5)
    jtr = JaxTrainer(jnet, jds, learning_rate=1e-3, momentum=0.9,
                     max_epochs=1, hybrid_online_batch=True,
                     padded_pipeline=True, device_cache=False)
    assert jtr.padded
    while not jtr.train_epoch():
        pass

    # the port's route: the wide tail, never K3
    calls = []
    wide = network_mod.softmax_ce_wide_fused

    def counted(*a, **k):
        calls.append(1)
        return wide(*a, **k)

    def refused(*a, **k):
        raise AssertionError("a 4200-class softmax took the projection tail")

    monkeypatch.setattr(network_mod, "softmax_ce_wide_fused", counted)
    monkeypatch.setattr(network_mod, "softmax_ce_proj_fused", refused)
    ds = DataSet([nc], parallel_sequences=2, sort_by_length=True,
                 prefetch=False)
    net = Network(LAYERS)
    net.init_params(5)
    tr = Trainer(net, ds, learning_rate=1e-3, momentum=0.9, max_epochs=1,
                 hybrid_online_batch=True, device="cpu")
    while not tr.train_epoch():
        pass
    assert len(calls) == ds.num_fractions() == 2

    assert tr.cur_training_error == pytest.approx(jtr.cur_training_error,
                                                  rel=1e-4)
    assert tr.cur_training_class_error == jtr.cur_training_class_error
    got, want = tr.exact_params(), jtr.exact_params()
    for name in want:
        for k in want[name]:
            np.testing.assert_allclose(got[name][k], np.asarray(want[name][k]),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"{name}.{k}")
