"""Weight noise and input noise in the port (lstm_rnn_tpu_torch/trainer.py,
data/dataset.py, the CLI's --weight_noise_sigma and --input_noise_sigma)
against the JAX package on the CPU, on tiny nets and corpora made from
seeds:

- the port's Trainer (kernel route: the twins and the fused tail) against
  the JAX Trainer (lax.scan on the exact layout) over 2 noisy epochs,
  stochastic and batch: the weight-noise draws bit for bit, the epoch
  errors and the weights;
- a noisy epoch against the float64 oracle fed the captured draws;
- the sequence-parallel route and the remat route with noise against the
  plain route;
- input noise through cli.main against the JAX CLI on an autoencoder-
  shaped (sse) and a classifier-shaped net;
- the streams that --continue replays: skip_epochs and the Trainer's
  weight-noise discard against real epochs.
"""

import json

import numpy as np
import pytest

from lstm_rnn_tpu import cli as jax_cli
from lstm_rnn_tpu.data.dataset import DataSet as JaxDataSet
from lstm_rnn_tpu.network import Network as JaxNetwork
from lstm_rnn_tpu.trainer import Trainer as JaxTrainer
from lstm_rnn_tpu_torch import cli
from lstm_rnn_tpu_torch.data.dataset import DataSet, discard_normals
from lstm_rnn_tpu_torch.data.netcdf3 import strings_to_chars, write_netcdf
from lstm_rnn_tpu_torch.network import Network
from lstm_rnn_tpu_torch.parallel.mesh import make_seq_mesh
from lstm_rnn_tpu_torch.trainer import Trainer
from tests import oracle_net
from tests.test_data import _write_classification_nc
from tests.test_torch_trainer import LAYERS, TRAIN_LENGTHS, VAL_LENGTHS

SIGMA = 0.05


def _corpus(tmp_path):
    train, val = str(tmp_path / "train.nc"), str(tmp_path / "val.nc")
    _write_classification_nc(train, TRAIN_LENGTHS, seed=1)
    _write_classification_nc(val, VAL_LENGTHS, seed=2)
    return train, val


def _capture(tr, to_numpy, monkeypatch):
    """Record every weight-noise draw the Trainer makes, as numpy trees."""
    drawn = []
    orig = tr._draw_noise

    def capture():
        n = orig()
        drawn.append({k: {kk: to_numpy(v) for kk, v in layer.items()}
                      for k, layer in n.items()})
        return n

    monkeypatch.setattr(tr, "_draw_noise", capture)
    return drawn


def _noisy_run(pkg, stochastic, tmp_path, monkeypatch, epochs=2,
               seq_mesh=None, remat_blocks=0):
    train, val = _corpus(tmp_path)
    if pkg == "jax":
        DS, Net, extra = JaxDataSet, JaxNetwork, {"device_cache": False}
    else:
        DS, Net, extra = DataSet, Network, {"device": "cpu",
                                            "seq_mesh": seq_mesh}
    train_set = DS([train], parallel_sequences=3, sort_by_length=True,
                   seed=11)
    val_set = DS([val], parallel_sequences=3, sort_by_length=True, seed=11)
    net = Net(LAYERS)
    net.init_params(7)
    net.remat_blocks = remat_blocks
    Tr = JaxTrainer if pkg == "jax" else Trainer
    tr = Tr(net, train_set, val_set, learning_rate=0.05, momentum=0.9,
            max_epochs=epochs, hybrid_online_batch=stochastic,
            weight_noise_sigma=SIGMA, seed=23, **extra)
    if pkg == "jax":
        assert not tr.padded  # the exact layout, as the port's
    drawn = _capture(tr, np.asarray if pkg == "jax"
                     else (lambda t: t.cpu().numpy()), monkeypatch)
    rows = []
    finished = False
    while not finished:
        finished = tr.train_epoch()
        rows.append((tr.cur_training_error, tr.cur_training_class_error,
                     tr.cur_validation_error, tr.cur_validation_class_error))
    params = {n: {k: np.asarray(v) for k, v in layer.items()}
              for n, layer in tr.exact_params().items()}
    return rows, params, drawn, train_set


@pytest.mark.parametrize("stochastic", [True, False],
                         ids=["stochastic", "batch"])
def test_weight_noise_matches_jax_trainer(stochastic, tmp_path, monkeypatch):
    rows_j, params_j, drawn_j, ds = _noisy_run("jax", stochastic, tmp_path,
                                               monkeypatch)
    rows, params, drawn, _ = _noisy_run("port", stochastic, tmp_path,
                                        monkeypatch)
    # one draw per training fraction, none in the val passes
    assert len(drawn) == len(drawn_j) == 2 * ds.num_fractions()
    for got, want in zip(drawn, drawn_j):
        assert list(got) == sorted(want)  # the JAX tree order
        for n in want:
            assert list(got[n]) == sorted(want[n])
            for k in want[n]:
                assert got[n][k].dtype == want[n][k].dtype == np.float32
                np.testing.assert_array_equal(got[n][k], want[n][k])
    # the bounds of test_torch_trainer.py: true f32 on both sides, the
    # twins and the fused tail against lax.scan and the unfused losses
    np.testing.assert_allclose(rows, rows_j, rtol=1e-5, atol=1e-6)
    for name in params_j:
        for k in params_j[name]:
            np.testing.assert_allclose(params[name][k], params_j[name][k],
                                       rtol=0, atol=1e-5,
                                       err_msg=f"{name}/{k}")


def test_weight_noise_changes_the_run(tmp_path, monkeypatch):
    """The control: the same run without noise trains other weights."""
    _, noisy, _, _ = _noisy_run("port", True, tmp_path, monkeypatch,
                                epochs=1)
    train, val = _corpus(tmp_path)
    net = Network(LAYERS)
    net.init_params(7)
    tr = Trainer(net, DataSet([train], parallel_sequences=3,
                              sort_by_length=True, seed=11),
                 learning_rate=0.05, momentum=0.9, max_epochs=1,
                 hybrid_online_batch=True, device="cpu")
    tr.train_epoch()
    clean = tr.exact_params()
    assert max(np.abs(noisy[n][k] - clean[n][k]).max()
               for n in clean for k in clean[n]) > 1e-4


@pytest.mark.parametrize("stochastic", [True, False],
                         ids=["stochastic", "batch"])
def test_weight_noise_epoch_matches_oracle(stochastic, tmp_path,
                                           monkeypatch):
    """A noisy epoch against the float64 oracle fed the captured draws:
    the gradient at the noisy point, the update to the clean weights
    (tests/test_end_to_end.py's bound for the JAX Trainer)."""
    nc = str(tmp_path / "t.nc")
    _write_classification_nc(nc, [9, 4, 12, 7, 3, 10], seed=4)
    ds = DataSet([nc], parallel_sequences=3, sort_by_length=True,
                 prefetch=False)
    net = Network(LAYERS)
    net.init_params(5)
    params0 = {k: {kk: np.asarray(vv, np.float64) for kk, vv in v.items()}
               for k, v in net.params.items()}
    tr = Trainer(net, ds, learning_rate=1e-2, momentum=0.9, max_epochs=1,
                 hybrid_online_batch=stochastic, weight_noise_sigma=SIGMA,
                 seed=9, device="cpu")
    drawn = _capture(tr, lambda t: t.cpu().numpy(), monkeypatch)
    tr.train_epoch()
    fracs = [(f.inputs, f.targets, f.pattypes) for f in ds.fractions()]
    assert len(drawn) == len(fracs)
    layer_lr = {s.name: s.learning_rate for s in net.specs
                if s.learning_rate >= 0}
    p_ref, _, err_ref, _ = oracle_net.train_epoch(
        net.specs, params0, fracs, lr=1e-2, momentum=0.9, layer_lr=layer_lr,
        stochastic=stochastic, noise=drawn)
    err = tr.cur_training_error
    assert abs(err - err_ref / ds.total_sequences) < 5e-3 * abs(err)
    got = tr.exact_params()
    for name in p_ref:
        for kk in p_ref[name]:
            upd_ref = p_ref[name][kk] - params0[name][kk]
            upd = np.asarray(got[name][kk], np.float64) - params0[name][kk]
            scale = np.abs(upd_ref).max() + 1e-12
            e = np.abs(upd - upd_ref).max()
            assert e < 2e-3 * scale + 5e-8, (
                f"{name}.{kk}: max update err {e:.3e} vs scale {scale:.3e}")


@pytest.mark.parametrize("route", ["sp", "remat"])
def test_weight_noise_routes_match_plain(route, tmp_path, monkeypatch):
    """The same noisy run through sequence parallelism (2 blocks on the
    CPU, the unfused tail) and through --remat_blocks 2 (checkpointed
    carry twins, the plain tail): the same draws, the plain route's
    errors and weights (test_torch_sequence.py's bounds)."""
    rows, params, drawn, _ = _noisy_run("port", True, tmp_path, monkeypatch)
    kw = ({"seq_mesh": make_seq_mesh(2, "cpu")} if route == "sp"
          else {"remat_blocks": 2})
    rows_r, params_r, drawn_r, _ = _noisy_run("port", True, tmp_path,
                                              monkeypatch, **kw)
    assert len(drawn_r) == len(drawn)
    for got, want in zip(drawn_r, drawn):
        for n in want:
            for k in want[n]:
                np.testing.assert_array_equal(got[n][k], want[n][k])
    np.testing.assert_allclose(rows_r, rows, rtol=1e-5)
    for name in params:
        for k in params[name]:
            np.testing.assert_allclose(params_r[name][k], params[name][k],
                                       rtol=0, atol=1e-6,
                                       err_msg=f"{name}/{k}")


# ------------------------------------------------------------ input noise
AE_LAYERS = [
    {"name": "input", "type": "input", "size": 3},
    {"name": "l1", "type": "blstm", "size": 4, "bias": 1.0},
    {"name": "l2", "type": "blstm", "size": 6, "bias": 1.0},
    {"name": "output", "type": "feedforward_identity", "size": 3,
     "bias": 1.0},
    {"name": "postoutput", "type": "sse", "size": 3},
]
CLS_LAYERS = [
    {"name": "input", "type": "input", "size": 3},
    {"name": "l1", "type": "blstm", "size": 4, "bias": 1.0},
    {"name": "sub", "type": "feedforward_tanh", "size": 3, "bias": 1.0},
    {"name": "l2", "type": "blstm", "size": 6, "bias": 1.0},
    {"name": "output", "type": "softmax", "size": 5, "bias": 1.0},
    {"name": "postoutput", "type": "multiclass_classification", "size": 5},
]


def _write_regression_nc(path, lengths, size, seed):
    """An autoencoder corpus: N(0, 1) inputs that are their own targets."""
    rng = np.random.RandomState(seed)
    total = sum(lengths)
    x = rng.randn(total, size).astype(np.float32)
    write_netcdf(path, {"numSeqs": len(lengths), "numTimesteps": total,
                        "inputPattSize": size, "targetPattSize": size,
                        "maxSeqTagLength": 8}, [
        ("seqTags", ["numSeqs", "maxSeqTagLength"],
         strings_to_chars([f"s{i}" for i in range(len(lengths))], 8)),
        ("seqLengths", ["numSeqs"], np.asarray(lengths, np.int32)),
        ("inputs", ["numTimesteps", "inputPattSize"], x),
        ("targetPatterns", ["numTimesteps", "targetPattSize"], x),
    ])


def _noise_args(tmp_path, kind, sigma):
    train, val = str(tmp_path / "train.nc"), str(tmp_path / "val.nc")
    if kind == "autoencoder":
        _write_regression_nc(train, [6, 5, 4, 7, 3, 8], 3, seed=7)
        _write_regression_nc(val, [5, 6], 3, seed=8)
        layers = AE_LAYERS
    else:
        _write_classification_nc(train, [6, 5, 4, 7, 3, 8], in_size=3,
                                 num_labels=5, seed=7)
        _write_classification_nc(val, [5, 6], in_size=3, num_labels=5,
                                 seed=8)
        layers = CLS_LAYERS
    net = str(tmp_path / f"{kind}.jsn")
    with open(net, "w") as f:
        json.dump({"layers": layers}, f)
    # the CHiME configs' flags at a tiny size
    return ["--network", net, "--train", "true", "--train_file", train,
            "--val_file", val, "--stochastic", "true",
            "--shuffle_fractions", "true", "--weights_dist", "normal",
            "--weights_normal_sigma", "0.1", "--learning_rate", "0.05",
            "--parallel_sequences", "2", "--max_epochs", "2",
            "--random_seed", "5", "--input_noise_sigma", str(sigma),
            "--device", "cpu"]


def _trained(main, args, cwd, monkeypatch):
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    assert main(args) == 0
    with open(cwd / "trained_network.jsn") as f:
        return {(n, k): np.asarray(v) for n, sec in
                json.load(f)["weights"].items() for k, v in sec.items()}


@pytest.mark.parametrize("kind", ["autoencoder", "classifier"])
def test_input_noise_cli_matches_jax_cli(kind, tmp_path, monkeypatch,
                                         capsys):
    args = _noise_args(tmp_path, kind, 0.6)
    want = _trained(jax_cli.main, args, tmp_path / "jax", monkeypatch)
    capsys.readouterr()
    got = _trained(cli.main, args, tmp_path / "port", monkeypatch)
    assert ("Using input noise with a standard deviation of 0.6."
            in capsys.readouterr().out)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=str(k))
    # the control: without the noise the run trains other weights
    clean = _trained(cli.main, _noise_args(tmp_path, kind, 0.0),
                     tmp_path / "clean", monkeypatch)
    assert max(np.abs(clean[k] - got[k]).max() for k in got
               if got[k].size) > 1e-4


# --------------------------------------------------- the --continue streams
def test_skip_epochs_replays_the_input_noise(tmp_path):
    """skip_epochs(n) leaves the DataSet's stream where n real epochs of
    shuffled, noisy fractions leave it: the next epoch's fractions are the
    same, noise included."""
    nc = str(tmp_path / "t.nc")
    _write_classification_nc(nc, [9, 4, 12, 7, 3, 10, 6], seed=4)

    def ds():
        return DataSet([nc], parallel_sequences=3, fraction_shuffling=True,
                       sequence_shuffling=True, noise_deviation=0.3,
                       trunc_seq_length=5, seed=17, prefetch=False)
    real, skipped = ds(), ds()
    for _ in range(3):
        for _ in real.fractions():
            pass
    skipped.skip_epochs(3)
    for a, b in zip(real.fractions(), skipped.fractions()):
        np.testing.assert_array_equal(a.inputs, b.inputs)
        assert a.seq_info == b.seq_info
    assert real._rng.standard_normal() == skipped._rng.standard_normal()


def test_skip_noise_replays_the_weight_noise(tmp_path):
    """The Trainer's discard of n epochs of weight-noise draws leaves the
    stream where n epochs of real draws (one per training fraction, leaf
    by leaf) leave it, an odd count of normals included (the legacy
    Gaussian's spare value)."""
    train, _ = _corpus(tmp_path)
    ds = DataSet([train], parallel_sequences=3, prefetch=False)

    def trainer():
        net = Network(LAYERS)
        net.init_params(7)
        return Trainer(net, ds, weight_noise_sigma=SIGMA, seed=23,
                       device="cpu")
    real, skipped = trainer(), trainer()
    n = sum(v.numel() for v in real._leaves(real.params))
    assert n % 2 == 1
    for _ in range(2 * ds.num_fractions()):
        real._draw_noise()
    skipped.skip_noise(2)
    a, b = real._draw_noise(), skipped._draw_noise()
    for name in a:
        for k in a[name]:
            assert np.array_equal(a[name][k].numpy(), b[name][k].numpy())
    # a discard in chunks that split the draws
    drawn, skipped = np.random.RandomState(3), np.random.RandomState(3)
    for size in (5, 1, 994):
        drawn.normal(0.0, 0.3, size)
    discard_normals(skipped, 1000, chunk=7)
    assert drawn.normal() == skipped.normal()
