"""The port's autosave, --autosave_best and --continue (lstm_rnn_tpu_torch
cli.py and trainer.py) against the JAX CLI on the same tiny corpus and
network: the autosave document, the best network, a resumed run against
the uninterrupted one, the terminal autosave, a dump that runs while the
next epoch updates the tensors in place, and a failing dump."""

import json
import threading

import numpy as np
import pytest

from lstm_rnn_tpu import cli as jax_cli
from lstm_rnn_tpu_torch import cli
from lstm_rnn_tpu_torch import io_currennt as ioc
from lstm_rnn_tpu_torch.config import parse_config
from lstm_rnn_tpu_torch.data.dataset import DataSet
from lstm_rnn_tpu_torch.network import Network
from lstm_rnn_tpu_torch.trainer import Trainer
from tests.test_data import _write_classification_nc

LAYERS = [
    {"name": "input", "type": "input", "size": 3},
    {"name": "l1", "type": "blstm", "size": 4, "bias": 1.0},
    {"name": "output", "type": "softmax", "size": 5, "bias": 1.0},
    {"name": "postoutput", "type": "multiclass_classification", "size": 5},
]
STATE_KEYS = ("optimizer_best_weights",
              "steepest_descent_optimizer_weight_deltas")


def _args(tmp_path, *extra):
    train, val = str(tmp_path / "train.nc"), str(tmp_path / "val.nc")
    _write_classification_nc(train, [6, 5, 4, 7, 3, 8], in_size=3,
                             num_labels=5, seed=7)
    _write_classification_nc(val, [5, 6], in_size=3, num_labels=5, seed=11)
    net = str(tmp_path / "net.jsn")
    with open(net, "w") as f:
        json.dump({"layers": LAYERS}, f)
    return ["--network", net, "--train", "true", "--train_file", train,
            "--val_file", val, "--stochastic", "true",
            "--learning_rate", "0.05", "--parallel_sequences", "2",
            "--random_seed", "5", "--device", "cpu", *extra]


def _run(main, args, cwd, monkeypatch):
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    assert main(args) == 0


def _load(path):
    with open(path) as f:
        return json.load(f)


def _weights(doc):
    return {(name, k): np.asarray(v) for name, sec in doc["weights"].items()
            for k, v in sec.items()}


def test_autosave_document_matches_jax(tmp_path, monkeypatch):
    args = _args(tmp_path, "--max_epochs", "2", "--autosave", "true")
    _run(jax_cli.main, args, tmp_path / "jax", monkeypatch)
    _run(cli.main, args, tmp_path / "port", monkeypatch)
    for epoch in (1, 2):
        name = f"epoch{epoch:03d}.autosave"
        want = _load(tmp_path / "jax" / name)
        got = _load(tmp_path / "port" / name)
        assert sorted(got) == sorted(want)
        # the same flags, serialised the same way, re-parse to a resumable
        # configuration
        assert got["configuration"] == want["configuration"]
        assert got["optimizer_cur_epoch"] == epoch
        assert got["optimizer_finished"] is want["optimizer_finished"] is (
            epoch == 2)
        for key in ("optimizer_epochs_since_lowest_error",):
            assert got[key] == want[key]
        for key in ("optimizer_lowest_validation_error",
                    "optimizer_cur_training_error",
                    "optimizer_cur_validation_error",
                    "optimizer_cur_training_class_error",
                    "optimizer_cur_validation_class_error"):
            assert got[key] == pytest.approx(want[key], rel=1e-5), key
        assert got["info_rows"].count(";;;") == want["info_rows"].count(
            ";;;") == epoch
        for key in STATE_KEYS:
            assert [len(x) for x in got[key]] == [len(x) for x in want[key]]
            for g, w in zip(got[key], want[key]):
                if w:
                    # true f32 on both sides after stochastic updates, the
                    # deltas relative to their largest entry
                    np.testing.assert_allclose(
                        g, w, rtol=0, atol=1e-4 * np.abs(w).max(),
                        err_msg=key)
        wg, ww = _weights(got), _weights(want)
        assert wg.keys() == ww.keys()
        for k in ww:
            np.testing.assert_allclose(wg[k], ww[k], rtol=0, atol=1e-5,
                                       err_msg=str(k))


def test_autosave_best_matches_jax(tmp_path, monkeypatch):
    for label, main in (("jax", jax_cli.main), ("port", cli.main)):
        prefix = str(tmp_path / label)
        _run(main, _args(tmp_path, "--max_epochs", "3", "--autosave_best",
                         "true", "--autosave_prefix", prefix),
             tmp_path / f"run_{label}", monkeypatch)
    got = _weights(_load(tmp_path / "port.best.jsn"))
    want = _weights(_load(tmp_path / "jax.best.jsn"))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=str(k))


# the flags of each case: fractions in order or shuffled; shuffled with
# input noise (the DataSet's stream); weight noise (the Trainer's stream)
CONTINUE_CASES = {
    "false": ["--shuffle_fractions", "false"],
    "true": ["--shuffle_fractions", "true"],
    "input_noise": ["--shuffle_fractions", "true", "--input_noise_sigma",
                    "0.6"],
    "weight_noise": ["--weight_noise_sigma", "0.05"],
}


@pytest.mark.parametrize("shuffle", list(CONTINUE_CASES))
def test_continue_equals_straight_run(tmp_path, monkeypatch, shuffle):
    """3 epochs straight == 2 epochs + autosave + --continue for 1 more
    (JAX tests/test_cli.py:56-92): the resumed run restores weights,
    momentum and counters; with shuffled fractions it also replays the
    shuffles of the epochs done, with input noise the noise draws of
    those epochs, and with weight noise it discards that stream's draws
    (where the JAX package starts both streams again at the seed)."""
    args = _args(tmp_path, "--max_epochs", "3", "--autosave", "true",
                 *CONTINUE_CASES[shuffle])
    _run(cli.main, args, tmp_path / "straight", monkeypatch)
    autosave = tmp_path / "straight" / "epoch002.autosave"
    doc = _load(autosave)
    assert doc["optimizer_cur_epoch"] == 2
    assert doc["optimizer_finished"] is False
    # --continue ignores every other flag: the stored configuration runs
    _run(cli.main, ["--continue", str(autosave)], tmp_path / "resumed",
         monkeypatch)
    got = _weights(_load(tmp_path / "resumed" / "trained_network.jsn"))
    want = _weights(_load(tmp_path / "straight" / "trained_network.jsn"))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7,
                                   err_msg=str(k))
    # the resumed run's final autosave equals the straight run's
    final = _load(tmp_path / "resumed" / "epoch003.autosave")
    straight = _load(tmp_path / "straight" / "epoch003.autosave")
    for key in STATE_KEYS:
        for g, w in zip(final[key], straight[key]):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)


def test_terminal_autosave_stores_restored_best_weights(tmp_path,
                                                        monkeypatch):
    """The reference restores the best weights before the final state save
    (Optimizer.cu:318, main.cpp:276-277), so the terminal autosave holds
    them, not the stop epoch's weights (JAX tests/test_cli.py:148-189)."""
    args = _args(tmp_path, "--learning_rate", "10.0", "--momentum", "0.0",
                 "--max_epochs", "6", "--max_epochs_no_best", "2",
                 "--autosave", "true")
    d = tmp_path / "run"
    _run(cli.main, args, d, monkeypatch)
    saves = sorted(d.glob("epoch*.autosave"))
    assert len(saves) >= 3
    last = _load(saves[-1])
    assert last["optimizer_finished"] is True
    # lr 10 diverges: the run stops on max_epochs_no_best, the best epoch
    # two behind
    assert last["optimizer_epochs_since_lowest_error"] == 2
    got, prev = _weights(last), _weights(_load(saves[-2]))
    want = _weights(_load(d / "trained_network.jsn"))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
    # not vacuous: the restored best differs from the epoch before
    assert any(not np.array_equal(got[k], prev[k]) for k in want)
    # and it is the best epoch's autosave weights
    best = _weights(_load(saves[-3]))
    for k in want:
        np.testing.assert_array_equal(got[k], best[k], err_msg=str(k))


def _one_epoch(tmp_path, max_epochs):
    """(config, network, a Trainer one epoch into its run) on the CPU."""
    cfg = parse_config(_args(tmp_path, "--autosave", "true"))
    net = Network(LAYERS)
    net.init_params(1)
    ds = DataSet([cfg.training_files[0]], parallel_sequences=2,
                 prefetch=False)
    tr = Trainer(net, ds, device="cpu", max_epochs=max_epochs,
                 hybrid_online_batch=True, learning_rate=0.05)
    tr.train_epoch()
    return cfg, net, tr


def test_dump_writes_the_epoch_it_was_started_for(tmp_path, monkeypatch):
    """torch updates the parameters and the deltas in place: an autosave
    whose dump runs while the next epoch trains still holds the epoch it
    was started for."""
    cfg, net, tr = _one_epoch(tmp_path, max_epochs=2)
    monkeypatch.chdir(tmp_path)
    want = tr.export_state()
    want_w = tr.exact_params()
    gate = threading.Event()
    write = ioc.save_network_json

    def held(*a, **k):
        assert gate.wait(60)
        write(*a, **k)

    monkeypatch.setattr(ioc, "save_network_json", held)
    saver = cli._save_autosave(cfg, net, tr, "rows")
    tr.train_epoch()  # the next epoch, before the dump runs
    moved = tr.exact_params()
    assert not np.array_equal(moved["l1"]["W_in"], want_w["l1"]["W_in"])
    gate.set()
    cli._join_saver(saver)
    got = _load(tmp_path / "epoch001.autosave")
    assert got["optimizer_cur_epoch"] == 1
    for key in STATE_KEYS:
        for g, w in zip(got[key], want[key]):
            np.testing.assert_array_equal(g, w, err_msg=key)
    flat = ioc.weights_section_from_params(net.layers_json(), want_w)
    for (name, part), v in _weights(got).items():
        np.testing.assert_array_equal(v, flat[name][part],
                                      err_msg=f"{name}.{part}")


def test_failing_dump_aborts_the_run(tmp_path, monkeypatch):
    """A failed checkpoint write on the dump thread is raised at the join,
    not left to the thread's default hook."""
    cfg, net, tr = _one_epoch(tmp_path, max_epochs=1)
    monkeypatch.chdir(tmp_path)

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ioc, "save_network_json", boom)
    saver = cli._save_autosave(cfg, net, tr, "rows")
    with pytest.raises(OSError, match="disk full"):
        cli._join_saver(saver)
    assert not list(tmp_path.glob("*.autosave"))
