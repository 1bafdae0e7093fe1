"""Sequence parallelism in the port (lstm_rnn_tpu_torch.parallel:
loss_and_count_seq, apply_seq, Trainer(seq_mesh=), `cli --seq_devices`)
against the JAX package's, on the same numpy inputs and weights.

The port's seq mesh here is the CPU named n times (one process, every time
block on the CPU); the JAX side runs on its n forced host devices
(tests/conftest.py). Both routes are held: the port's kernel route (the
carry kernels' twins, K6b under autograd) against the JAX carry kernel in
interpret mode (backend "pallas_interpret"), and the port's scan route
against JAX's scan route. Tolerances are the JAX package's own for its SP
against its single-device net (tests/test_sequence.py:48-93).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lstm_rnn_tpu import cli as jax_cli
from lstm_rnn_tpu.network import Network as JaxNetwork
from lstm_rnn_tpu.ops.masking import pattypes_from_lengths
from lstm_rnn_tpu.parallel.mesh import make_mesh
from lstm_rnn_tpu.parallel.sequence import apply_seq as jax_apply_seq
from lstm_rnn_tpu.parallel.sequence import \
    loss_and_count_seq as jax_loss_and_count_seq
from lstm_rnn_tpu_torch import cli
from lstm_rnn_tpu_torch.network import Network
from lstm_rnn_tpu_torch.parallel import mesh as port_mesh
from lstm_rnn_tpu_torch.parallel.mesh import make_seq_mesh
from lstm_rnn_tpu_torch.parallel.sequence import (apply_seq,
                                                  loss_and_count_seq)
from tests.test_cli import _assert_csv_close
from tests.test_data import _write_classification_nc
from tests.test_sequence import LAYERS

# (port backend, JAX backend, loss rtol, grad rtol = atol): the JAX
# package's bounds for its scan SP (1e-6; its tree check 2e-5 / 1e-6) and
# for its fused SP (2e-5; 5e-4)
ROUTES = {"kernel": ("auto", "pallas_interpret", 2e-5, 5e-4),
          "scan": ("scan", "scan", 1e-6, 2e-5)}


def _batch(t, b=4, seed=1234):
    """tests/test_sequence.py's batch: one full row and shorter ones, so
    carries cross block boundaries inside and outside the valid region."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (t, b, 3)).astype(np.float32)
    lens = [t] + [max(1, t - 1 - i) for i in range(b - 1)]
    pt = np.asarray(pattypes_from_lengths(lens, t, b))
    tc = rng.randint(0, 4, (t, b)).astype(np.int32)
    return x, tc, pt


def _nets(route, layers=LAYERS, seed=11):
    port_backend, jax_backend = ROUTES[route][:2]
    jnet = JaxNetwork(layers, backend=jax_backend)
    jnet.init_params(seed)
    net = Network(layers, backend=port_backend)
    net.params = jnet.params
    return jnet, net


@functools.lru_cache(maxsize=None)
def _jax_seq(route, n, t):
    jnet, _ = _nets(route)
    params = jax.tree_util.tree_map(jnp.asarray, jnet.params)
    x, tc, pt = map(jnp.asarray, _batch(t))
    mesh = make_mesh(n, axis="seq")

    def sp(p):
        return jax_loss_and_count_seq(jnet, p, x, tc, pt, mesh)

    (err, corr), grads = jax.jit(jax.value_and_grad(sp, has_aux=True))(
        params)
    y = jax.jit(lambda p: jax_apply_seq(jnet, p, x, pt, mesh))(params)
    return (float(err), int(corr),
            jax.tree_util.tree_map(np.asarray, grads), np.asarray(y))


def _port_seq(net, n, x, tc, pt):
    """(error, count, grads, apply_seq output) of the port on an n-block
    CPU mesh."""
    params = net.device_params("cpu")
    leaves = [v.requires_grad_(True) for layer in params.values()
              for v in layer.values()]
    mesh = make_seq_mesh(n, "cpu")
    err, corr = loss_and_count_seq(net, params, *map(torch.from_numpy,
                                                     (x, tc, pt)), mesh)
    grads = torch.autograd.grad(err, leaves)
    it = iter(grads)
    tree = {name: {k: next(it).numpy() for k in layer}
            for name, layer in params.items()}
    with torch.inference_mode():
        y = apply_seq(net, params, torch.from_numpy(x), torch.from_numpy(pt),
                      mesh)
    return err.item(), int(corr), tree, y.numpy()


def _assert_grads_close(got, want, rtol, atol):
    assert sorted(got) == sorted(want)
    for name in want:
        for k in want[name]:
            np.testing.assert_allclose(got[name][k], want[name][k],
                                       rtol=rtol, atol=atol,
                                       err_msg=f"{name}/{k}")


@pytest.mark.parametrize("n, t", [(2, 8), (4, 7)])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_seq_matches_jax(route, n, t):
    """loss_and_count_seq (loss, count, gradients) and apply_seq against the
    JAX package's on a 2- and a 4-block mesh, the second with a T that n
    does not divide."""
    _, net = _nets(route)
    _, _, loss_rtol, grad_tol = ROUTES[route]
    e_want, c_want, g_want, y_want = _jax_seq(route, n, t)
    e_got, c_got, g_got, y_got = _port_seq(net, n, *_batch(t))
    np.testing.assert_allclose(e_got, e_want, rtol=loss_rtol)
    assert c_got == c_want
    _assert_grads_close(g_got, g_want, grad_tol,
                        grad_tol if route == "kernel" else 1e-6)
    assert y_got.shape == y_want.shape == (t, 4, 4)
    np.testing.assert_allclose(y_got, y_want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_seq_matches_port_single_device(route, n):
    """The port's SP against its own single-device net (apply, loss_fn,
    autograd): the blocks chained by carries are the whole sequence."""
    _, net = _nets(route)
    x, tc, pt = _batch(7)
    params = net.device_params("cpu")
    leaves = [v.requires_grad_(True) for layer in params.values()
              for v in layer.values()]
    xt, tct, ptt = map(torch.from_numpy, (x, tc, pt))
    y = net.apply(params, xt, ptt)
    err = net.loss_fn(y, tct, ptt)
    want = torch.autograd.grad(err, leaves)
    e_sp, c_sp = loss_and_count_seq(net, params, xt, tct, ptt,
                                    make_seq_mesh(n, "cpu"))
    got = torch.autograd.grad(e_sp, leaves)
    np.testing.assert_allclose(e_sp.item(), err.item(), rtol=1e-6)
    assert int(c_sp) == int(net.correct_count(y, tct, ptt))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_seq_regression_loss_matches_jax(route):
    """An sse net ([T, B, W] targets, padded with zeros) on 4 blocks: the
    loss and the gradients against the JAX package's SP."""
    layers = [
        {"name": "input", "type": "input", "size": 3},
        {"name": "b1", "type": "blstm", "size": 4, "bias": 1.0},
        {"name": "output", "type": "feedforward_identity", "size": 2,
         "bias": 1.0},
        {"name": "post", "type": "sse", "size": 2},
    ]
    jnet, net = _nets(route, layers, seed=7)
    _, _, loss_rtol, grad_tol = ROUTES[route]
    rng = np.random.RandomState(3)
    t, b = 6, 4
    x = rng.uniform(-1, 1, (t, b, 3)).astype(np.float32)
    tg = rng.uniform(-1, 1, (t, b, 2)).astype(np.float32)
    pt = np.asarray(pattypes_from_lengths([t, t - 1, t - 2, 1], t, b))
    mesh = make_mesh(4, axis="seq")
    e_want, g_want = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_and_count_seq(jnet, p, *map(jnp.asarray,
                                                       (x, tg, pt)),
                                         mesh)[0]))(
        jax.tree_util.tree_map(jnp.asarray, jnet.params))
    e_got, _, g_got, _ = _port_seq(net, 4, x, tg, pt)
    np.testing.assert_allclose(e_got, float(e_want), rtol=loss_rtol)
    _assert_grads_close(g_got, jax.tree_util.tree_map(np.asarray, g_want),
                        grad_tol, grad_tol if route == "kernel" else 1e-6)


def test_pad_time_rows_are_inert():
    """T = 7 on 4 blocks pads one NONE row: the loss and output equal the
    unpadded single-device ones, and apply_seq returns T rows."""
    _, net = _nets("kernel")
    x, tc, pt = map(torch.from_numpy, _batch(7))
    params = net.device_params("cpu")
    mesh = make_seq_mesh(4, "cpu")
    with torch.inference_mode():
        y = apply_seq(net, params, x, pt, mesh)
        want = net.apply(params, x, pt)
        err, _ = loss_and_count_seq(net, params, x, tc, pt, mesh)
    assert y.shape == want.shape
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(err.item(),
                               net.loss_fn(want, tc, pt).item(), rtol=1e-6)


def _trainer_errors(seq_mesh, tmp_path):
    from lstm_rnn_tpu_torch.data.dataset import DataSet
    from lstm_rnn_tpu_torch.trainer import Trainer
    nc = str(tmp_path / "t.nc")
    _write_classification_nc(nc, [6, 5, 4, 7], in_size=3, num_labels=4,
                             seed=3)
    ds = DataSet([nc], parallel_sequences=2, prefetch=False, seed=1)
    net = Network(LAYERS)
    net.init_params(5)
    tr = Trainer(net, ds, ds, learning_rate=1e-2, momentum=0.9,
                 max_epochs=2, hybrid_online_batch=True, device="cpu",
                 seq_mesh=seq_mesh)
    assert tr.fused_tail is (seq_mesh is None)
    rows = []
    while not tr.train_epoch():
        rows.append((tr.cur_training_error, tr.cur_validation_error))
    rows.append((tr.cur_training_error, tr.cur_validation_error))
    return rows, tr.exact_params()


def test_trainer_seq_mesh_matches_single_device(tmp_path):
    """Trainer(seq_mesh=) over two epochs: the epoch errors and the trained
    weights of the single-device Trainer (the fused tail there, the
    unfused one under the mesh)."""
    rows, params = _trainer_errors(None, tmp_path)
    rows_sp, params_sp = _trainer_errors(make_seq_mesh(2, "cpu"), tmp_path)
    np.testing.assert_allclose(rows_sp, rows, rtol=1e-5)
    for name in params:
        for k in params[name]:
            np.testing.assert_allclose(params_sp[name][k], params[name][k],
                                       rtol=0, atol=1e-6)


# ------------------------------------------------------------------ CLI
def _cli_setup(tmp_path):
    nc = str(tmp_path / "data.nc")
    _write_classification_nc(nc, [6, 5, 1, 7, 3], in_size=3, num_labels=4,
                             seed=5)
    net_path = str(tmp_path / "network.jsn")
    with open(net_path, "w") as f:
        json.dump({"layers": LAYERS}, f)
    return nc, ["--network", net_path, "--parallel_sequences", "3",
                "--random_seed", "17", "--device", "cpu"]


def test_cli_forward_seq_devices_matches_jax(tmp_path, capsys):
    """`--train false --seq_devices 2`: the posteriors of both CLIs."""
    nc, common = _cli_setup(tmp_path)
    args = common + ["--train", "false", "--ff_input_file", nc,
                     "--seq_devices", "2"]
    assert jax_cli.main(args + ["--ff_output_file",
                                str(tmp_path / "jax.csv")]) == 0
    assert cli.main(args + ["--ff_output_file",
                            str(tmp_path / "port.csv")]) == 0
    assert "Sequence-parallel mesh: {'seq': 2}" in capsys.readouterr().out
    _assert_csv_close(tmp_path / "port.csv", tmp_path / "jax.csv")
    # and the port's single-device dump
    assert cli.main(common + ["--train", "false", "--ff_input_file", nc,
                              "--ff_output_file",
                              str(tmp_path / "one.csv")]) == 0
    _assert_csv_close(tmp_path / "port.csv", tmp_path / "one.csv")


def test_cli_train_seq_devices_matches_jax(tmp_path, capsys):
    """`--train true --seq_devices 2`: the trained networks of both CLIs,
    two epochs of stochastic updates."""
    from lstm_rnn_tpu import io_currennt as jax_ioc
    nc, common = _cli_setup(tmp_path)
    nc_val = str(tmp_path / "val.nc")
    _write_classification_nc(nc_val, [4, 6, 2], in_size=3, num_labels=4,
                             seed=6)
    args = common + ["--train", "true", "--train_file", nc,
                     "--val_file", nc_val, "--max_epochs", "2",
                     "--stochastic", "true", "--learning_rate", "0.05",
                     "--momentum", "0.9", "--seq_devices", "2"]
    outs = {}
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        outs[name] = str(tmp_path / f"{name}.jsn")
        assert main(args + ["--save_network", outs[name]]) == 0
    out = capsys.readouterr().out
    assert out.count("Sequence-parallel mesh: {'seq': 2} (time axis "
                     "sharded)") == 2
    want = jax_ioc.load_network_json(outs["jax"])["weights"]
    got = jax_ioc.load_network_json(outs["port"])["weights"]
    for name, layer in want.items():
        for part, values in layer.items():
            # true f32 on both sides after 2 epochs (test_torch_cli's bound)
            np.testing.assert_allclose(got[name][part], values, rtol=0,
                                       atol=1e-5, err_msg=f"{name}/{part}")


@pytest.mark.parametrize("extra, match", [
    (["--num_devices", "3"], "seq_devices=2 must divide num_devices=3"),
    (["--stream_chunk", "4"],
     "stream_chunk does not combine with pipeline_devices or seq_devices"),
    (["--pipeline_devices", "2"],
     "seq_devices > 1 does not combine with model_devices"),
])
def test_cli_refuses_seq_combinations(tmp_path, extra, match):
    """A --num_devices that --seq_devices does not divide (DP x SP runs:
    tests/test_torch_dp_sp.py), streaming and pipelines with
    --seq_devices are refused before any work, with the JAX CLI's
    messages."""
    nc, common = _cli_setup(tmp_path)
    with pytest.raises(ValueError, match=match):
        cli.main(common + ["--train", "false", "--ff_input_file", nc,
                           "--seq_devices", "2"] + extra)


def test_cli_seq_devices_zero_runs_without_sp(tmp_path, capsys):
    """`--seq_devices 0` is off, as in the JAX CLI (which tests only
    seq_devices > 1): both CLIs serve without a seq mesh, and the port's
    dump equals its dump without the flag and the JAX CLI's."""
    nc, common = _cli_setup(tmp_path)
    args = common + ["--train", "false", "--ff_input_file", nc]
    for name, main, extra in (("jax", jax_cli.main, ["--seq_devices", "0"]),
                              ("port", cli.main, ["--seq_devices", "0"]),
                              ("one", cli.main, [])):
        assert main(args + extra + ["--ff_output_file",
                                    str(tmp_path / f"{name}.csv")]) == 0
    assert "Sequence-parallel mesh" not in capsys.readouterr().out
    assert ((tmp_path / "port.csv").read_text()
            == (tmp_path / "one.csv").read_text())
    _assert_csv_close(tmp_path / "port.csv", tmp_path / "jax.csv")


def test_mesh_refusals(monkeypatch):
    """make_seq_mesh refuses more GPUs than torch sees (a mocked count),
    with the JAX CLI's message; the CPU mesh repeats the CPU."""
    assert make_seq_mesh(2, "cpu") == [torch.device("cpu")] * 2
    monkeypatch.setattr(port_mesh.torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError,
                       match="num_devices=2 but only 1 devices available"):
        make_seq_mesh(2)
    assert make_seq_mesh(1) == [torch.device("cuda", 0)]
