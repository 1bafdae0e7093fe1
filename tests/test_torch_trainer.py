"""The port's Trainer (lstm_rnn_tpu_torch/trainer.py) against the JAX
package's Trainer, both on the CPU, for two epochs on a tiny net
(4 -> BLSTM(6) -> BLSTM(6) -> softmax(5) -> multiclass_classification) and
a small corpus made from a seed: the per-epoch training and validation
errors and class errors, and the final weights.

The port runs its kernel route (the twins of the LSTM and tail kernels,
the fused tail); the JAX Trainer on the CPU runs its lax.scan path and the
unfused losses. Both draw the same initial weights from the seed and the
same fraction order from the data seed.
"""

import numpy as np
import pytest
import torch

from lstm_rnn_tpu.data.dataset import DataSet as JaxDataSet
from lstm_rnn_tpu.network import Network as JaxNetwork
from lstm_rnn_tpu.trainer import Trainer as JaxTrainer
from lstm_rnn_tpu_torch.data.dataset import DataSet
from lstm_rnn_tpu_torch.network import Network
from lstm_rnn_tpu_torch.trainer import Trainer
from tests.test_data import _write_classification_nc

LAYERS = [
    {"name": "input", "type": "input", "size": 4},
    {"name": "l1", "type": "blstm", "size": 6, "bias": 1.0},
    # a per-layer learning rate overrides the global one
    {"name": "l2", "type": "blstm", "size": 6, "bias": 1.0,
     "learningRate": 0.02},
    {"name": "output", "type": "softmax", "size": 5, "bias": 1.0},
    {"name": "postoutput", "type": "multiclass_classification", "size": 5},
]
TRAIN_LENGTHS = [9, 4, 12, 7, 3, 10, 6, 8]
VAL_LENGTHS = [5, 8, 3, 6]
# mode: (stochastic, shuffle_fractions, truncate_seq)
MODES = {"stochastic": (True, False, 0), "batch": (False, False, 0),
         "stochastic-shuffled-truncated": (True, True, 5)}


def _run(pkg, mode, tmp_path):
    stochastic, shuffle, trunc = MODES[mode]
    nc_train, nc_val = str(tmp_path / "train.nc"), str(tmp_path / "val.nc")
    _write_classification_nc(nc_train, TRAIN_LENGTHS, seed=1)
    _write_classification_nc(nc_val, VAL_LENGTHS, seed=2)
    if pkg == "jax":
        DS, Net, Tr, extra = JaxDataSet, JaxNetwork, JaxTrainer, {
            "device_cache": False}
    else:
        DS, Net, Tr, extra = DataSet, Network, Trainer, {"device": "cpu"}
    train = DS([nc_train], parallel_sequences=3, trunc_seq_length=trunc,
               fraction_shuffling=shuffle, sort_by_length=True, seed=11)
    val = DS([nc_val], parallel_sequences=3, sort_by_length=True, seed=11)
    net = Net(LAYERS)
    net.init_params(7)
    tr = Tr(net, train, val, learning_rate=0.05, momentum=0.9,
            max_epochs=2, hybrid_online_batch=stochastic, **extra)
    rows = []
    while not tr.train_epoch():
        rows.append(_row(tr))
    rows.append(_row(tr))
    params = tr.exact_params() if pkg == "port" else {
        n: {k: np.asarray(v) for k, v in layer.items()}
        for n, layer in tr.exact_params().items()}
    return rows, params, train.total_sequences


def _row(tr):
    return (tr.cur_training_error, tr.cur_training_class_error,
            tr.cur_validation_error, tr.cur_validation_class_error)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_two_epochs_match_jax_trainer(mode, tmp_path):
    rows_j, params_j, n_j = _run("jax", mode, tmp_path)
    rows, params, n = _run("port", mode, tmp_path)
    assert n == n_j
    if MODES[mode][2]:
        assert n > len(TRAIN_LENGTHS)  # truncation cut sequences
    assert len(rows) == len(rows_j) == 2
    # true f32 on both sides: the twins and the fused tail against lax.scan
    # and the unfused losses, sums in another order, over 2 epochs of
    # updates
    np.testing.assert_allclose(rows, rows_j, rtol=1e-5, atol=1e-6)
    assert rows[1][0] != rows[0][0]  # the weights moved
    for name in params_j:
        for k in params_j[name]:
            np.testing.assert_allclose(params[name][k], params_j[name][k],
                                       rtol=0, atol=1e-5,
                                       err_msg=f"{name}/{k}")


def test_trainer_defaults_to_the_card(monkeypatch):
    """A Trainer given no device takes the GPU, and raises without one
    instead of running the kernels' plain twins on the CPU."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    net = Network(LAYERS)
    net.init_params(7)
    with pytest.raises(RuntimeError, match="no GPU"):
        Trainer(net, None)
    assert Trainer(net, None, device="cpu").device.type == "cpu"


def test_one_epoch_f64_matches_oracle(tmp_path):
    """The port's twin of the JAX package's
    test_one_epoch_f64_machine_epsilon (tests/test_end_to_end.py) on a
    corpus made from a seed: one stochastic epoch of the scan route with
    float64 parameters on the CPU against the float64 oracle, at that
    test's bounds (the loss within 1e-8 relative, the class error
    identical, every update within max(1e-9, 1e-5 x its scale))."""
    from tests import oracle_net
    nc = str(tmp_path / "t.nc")
    _write_classification_nc(nc, TRAIN_LENGTHS, seed=1)
    ds = DataSet([nc], parallel_sequences=3, sort_by_length=True,
                 prefetch=False)
    net = Network(LAYERS, backend="scan", compute_dtype="float64")
    net.init_params(7)
    params0 = {k: {kk: np.asarray(vv, np.float64) for kk, vv in v.items()}
               for k, v in net.params.items()}
    tr = Trainer(net, ds, learning_rate=0.05, momentum=0.9, max_epochs=1,
                 hybrid_online_batch=True, device="cpu")
    assert all(v.dtype == torch.float64 for v in tr._leaves(tr.params))
    tr.train_epoch()
    fracs = [(f.inputs, f.targets, f.pattypes) for f in ds.fractions()]
    assert len(fracs) > 1  # updates between fractions are under test
    layer_lr = {s.name: s.learning_rate for s in net.specs
                if s.learning_rate >= 0}
    p_ref, _, err_ref, correct_ref = oracle_net.train_epoch(
        net.specs, params0, fracs, lr=0.05, momentum=0.9, layer_lr=layer_lr,
        stochastic=True)
    want = err_ref / ds.total_sequences
    assert abs(tr.cur_training_error - want) < 1e-8 * abs(want)
    assert tr.cur_training_class_error == 1.0 - correct_ref / ds.total_timesteps
    for name in p_ref:
        for kk in p_ref[name]:
            upd_ref = p_ref[name][kk] - params0[name][kk]
            upd = tr.params[name][kk].detach().numpy() - params0[name][kk]
            err = np.abs(upd - upd_ref).max()
            scale = np.abs(upd_ref).max()
            assert err <= max(1e-9, 1e-5 * scale), (
                f"{name}.{kk}: f64 update err {err:.3e} vs scale "
                f"{scale:.3e}")


def test_float64_stays_on_the_cpu_scan_route():
    """The card's paths are f32 and bf16: float64 takes the scan backend
    and a CPU Trainer."""
    with pytest.raises(ValueError, match="backend 'scan'"):
        Network(LAYERS, compute_dtype="float64")
    net = Network(LAYERS, backend="scan", compute_dtype="float64")
    net.init_params(7)
    with pytest.raises(ValueError, match="CPU only"):
        Trainer(net, None, device="meta")
