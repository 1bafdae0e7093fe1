"""Tensor parallelism in the port (lstm_rnn_tpu_torch.parallel.tensor:
shard_lstm_params, lstm_forward_tp; Network.model_mesh, validate_tp;
Trainer(model_mesh=); the CLI's --model_devices, in one process and as DP
x TP, and its --model_devices 0 heuristic) against the JAX package's, on
the same numpy inputs and weights.

The port's model mesh is the CPU named k times (one process, every shard
on the CPU); the JAX side runs on its forced host devices (tests/
conftest.py). Tolerances are the JAX package's own for its TP against its
one-device scan (tests/test_parallel.py:133-230): the loss rel 1e-5,
every gradient rtol 1e-4 / atol 1e-5; trained weights after 2 epochs
rtol 1e-5 / atol 1e-7 (tests/test_cli.py:260-300).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from lstm_rnn_tpu.network import Network as JaxNetwork
from lstm_rnn_tpu.ops.masking import pattypes_from_lengths
from lstm_rnn_tpu.parallel.tensor import lstm_forward_tp as jax_tp
from lstm_rnn_tpu_torch.network import Network
from lstm_rnn_tpu_torch.parallel import launch
from lstm_rnn_tpu_torch.parallel.tensor import (lstm_forward_tp,
                                                shard_lstm_params)
from tests.test_torch_data_parallel import (_assert_weights_close, _jax_ok,
                                            _port_ok)

CPU = torch.device("cpu")
LOSS_REL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
# tests/test_cli.py:260-275's net for --model_devices
CLI_LAYERS = [
    {"name": "input", "type": "input", "size": 3},
    {"name": "l1", "type": "blstm", "size": 4, "bias": 1.0},
    {"name": "output", "type": "softmax", "size": 4, "bias": 1.0},
    {"name": "postoutput", "type": "multiclass_classification", "size": 4}]


def _layer(rng, bidirectional, T=11, B=4, P=5, L=32):
    """tests/test_parallel.py:133-158's operands: h = 16 (32 uni), which
    the 8-way mesh divides."""
    d = 2 if bidirectional else 1
    h = L // d
    params = {k: rng.uniform(-1, 1, s).astype(np.float32) for k, s in (
        ("W_in", (d, P, 4, h)), ("W_rec", (d, h, 4, h)), ("b", (d, 4, h)),
        ("peep", (d, 3, h)))}
    x = rng.uniform(-1, 1, (T, B, P)).astype(np.float32)
    pt = np.asarray(pattypes_from_lengths([11, 6, 9, 4], T, B))
    dy = rng.uniform(-2, 2, (T, B, L)).astype(np.float32)
    return params, x, pt, dy


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("bidirectional", [False, True])
def test_lstm_forward_tp_matches_jax(rng, monkeypatch, bidirectional, n):
    """lstm_forward_tp's values and every parameter gradient against the
    JAX package's (jax.grad of its lstm_forward_tp on forced host
    devices) on an n-way model mesh, uni- and bidirectional, with ragged
    rows; every device's replica of the output is the same. The port's
    gradients come from LstmTPFused's backward on the CPU: the plain BPTT
    lstm_tp_bptt_reference, once."""
    from lstm_rnn_tpu_torch.ops import lstm_tp
    calls = []
    twin = lstm_tp.lstm_tp_bptt_reference
    monkeypatch.setattr(lstm_tp, "lstm_tp_bptt_reference",
                        lambda *a, **k: calls.append(1) or twin(*a, **k))
    params, x, pt, dy = _layer(rng, bidirectional)
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("model",))

    def loss_jax(p):
        return jnp.sum(jax_tp(p, jnp.asarray(x), jnp.asarray(pt), 1.0,
                              bidirectional, mesh) * jnp.asarray(dy))

    l_want, g_want = jax.value_and_grad(jax.jit(loss_jax))(
        jax.tree_util.tree_map(jnp.asarray, params))
    p_t = {k: torch.from_numpy(v).requires_grad_(True)
           for k, v in params.items()}
    ys = lstm_forward_tp(p_t, torch.from_numpy(x), torch.from_numpy(pt), 1.0,
                         bidirectional, [CPU] * n)
    assert len(ys) == n and all(torch.equal(y, ys[0]) for y in ys)
    loss = (ys[0] * torch.from_numpy(dy)).sum()
    grads = torch.autograd.grad(loss, list(p_t.values()))
    assert loss.item() == pytest.approx(float(l_want), rel=LOSS_REL)
    for k, g in zip(p_t, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(g_want[k]),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=k)
    assert calls == [1]


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("bidirectional", [False, True])
def test_lstm_tp_bptt_reference_matches_the_loop(rng, bidirectional, n):
    """LstmTPFused on the CPU (K8f's twin forward, the plain BPTT
    lstm_tp_bptt_reference, dW_rec and dpeep after the loop) against
    autograd through every step of lstm_forward_tp_reference, with a
    row that has invalid frames inside it (the masks reset h and c
    there): the same output bit for bit, every gradient (x's too) within
    f32 sum-order noise. The BPTT's shards exchange their partials in
    shard order, so the gradients do not depend on how the cells are
    cut beyond that noise."""
    from lstm_rnn_tpu_torch.parallel.tensor import lstm_forward_tp_reference
    params, x, pt, dy = _layer(rng, bidirectional)
    pt = pt.copy()
    pt[3:6, 0] = 0
    mesh = [CPU] * n
    results = []
    for fn in (lstm_forward_tp, lstm_forward_tp_reference):
        p_t = {k: torch.from_numpy(v).requires_grad_(True)
               for k, v in params.items()}
        xt = torch.from_numpy(x).requires_grad_(True)
        ys = fn(p_t, xt, torch.from_numpy(pt), 1.0, bidirectional, mesh)
        loss = (ys[0] * torch.from_numpy(dy)).sum()
        results.append((ys[0].detach(), torch.autograd.grad(
            loss, [xt, *p_t.values()])))
    (y, grads), (y_ref, grads_ref) = results
    assert torch.equal(y, y_ref)
    for g, want in zip(grads, grads_ref):
        np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_shard_lstm_params_owns_columns(rng):
    """Shard i holds cells [i H/n, (i+1) H/n) of each direction: the
    columns of W_in, W_rec (every row), b and peep; a width the mesh does
    not divide is refused."""
    params, *_ = _layer(rng, True)
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    shards = shard_lstm_params([CPU] * 4, p)
    for i, sh in enumerate(shards):
        for k, v in sh.items():
            assert torch.equal(v, p[k][..., 4 * i:4 * i + 4])
        assert sh["W_rec"].shape == (2, 16, 4, 4)
    with pytest.raises(ValueError, match="hidden size 16 must divide"):
        shard_lstm_params([CPU] * 3, p)


NET_LAYERS = [
    {"name": "input", "type": "input", "size": 5},
    {"name": "b1", "type": "blstm", "size": 8, "bias": 1.0},
    {"name": "ff", "type": "feedforward_tanh", "size": 6, "bias": 0.5},
    {"name": "l2", "type": "lstm", "size": 4, "bias": 1.0},
    {"name": "b3", "type": "blstm", "size": 8, "bias": 1.0},
    {"name": "output", "type": "softmax", "size": 3, "bias": 1.0},
    {"name": "post", "type": "multiclass_classification", "size": 3}]


def _net_batch(seed=3, T=9, B=4):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (T, B, 5)).astype(np.float32)
    pt = np.asarray(pattypes_from_lengths([9, 4, 7, 1], T, B))
    tc = np.where(pt > 0, rng.randint(0, 3, (T, B)), -1).astype(np.int32)
    return x, tc, pt


def _jax_tp_net(dtype="float32"):
    jnet = JaxNetwork(NET_LAYERS, compute_dtype=dtype)
    jnet.init_params(7)
    jnet.mesh = Mesh(np.asarray(jax.devices()[:2]), ("model",))
    jnet.validate_tp()
    return jnet


def _port_tp_net(params_np, dtype="float32", mesh=(CPU, CPU)):
    net = Network(NET_LAYERS, compute_dtype=dtype)
    net.params = params_np
    net.model_mesh = list(mesh) if mesh else None
    net.validate_tp()
    return net


def test_tp_network_matches_jax():
    """A net with TP layers on both sides of a feedforward layer (the next
    TP layer reads the previous one's replicas): the port's fused-tail
    loss, count and gradients on a 2-device model mesh (its Trainer's
    route) against the JAX net on its 2-device model mesh with its
    unfused tail (its Trainer's route under TP)."""
    jnet = _jax_tp_net()
    x, tc, pt = _net_batch()

    def loss(p):
        y = jnet.apply(p, jnp.asarray(x), jnp.asarray(pt))
        return (jnet.loss_fn(y, jnp.asarray(tc), jnp.asarray(pt)),
                jnet.correct_count(y, jnp.asarray(tc), jnp.asarray(pt)))

    (e_want, c_want), g_want = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(jax.tree_util.tree_map(jnp.asarray,
                                                    jnet.params))
    net = _port_tp_net(jnet.params)
    params = net.device_params("cpu")
    leaves = [v.requires_grad_(True) for layer in params.values()
              for v in layer.values()]
    err, corr = net.loss_and_count_fused(params, *map(torch.from_numpy,
                                                      (x, tc, pt)))
    grads = dict(zip([(n, k) for n in params for k in params[n]],
                     torch.autograd.grad(err, leaves)))
    assert err.item() == pytest.approx(float(e_want), rel=LOSS_REL)
    assert int(corr) == int(c_want)
    for (n, k), g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(g_want[n][k]),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=f"{n}/{k}")


def test_tp_layers_compute_in_f32_under_bf16():
    """Under --compute_dtype bfloat16 the TP layers take no compute dtype
    and compute in f32, as JAX's do (lstm_rnn_tpu/network.py:254-257):
    the port's hidden output through the last TP layer equals its f32
    net's bit for bit where no bf16 layer lies between (the first TP
    layer), equals the JAX bf16 TP net's to f32 sum-order noise through
    the bf16 feedforward layer, and the bf16 kernel route (the control,
    bf16 operands and h) fails that check."""
    jnet = _jax_tp_net("bfloat16")
    x, _, pt = _net_batch()
    want = np.asarray(jnet.apply_layer_range(
        jax.tree_util.tree_map(jnp.asarray, jnet.params), jnp.asarray(x),
        jnp.asarray(pt), 0, 4))
    xt, ptt = torch.from_numpy(x), torch.from_numpy(pt)
    with torch.no_grad():
        net = _port_tp_net(jnet.params, "bfloat16")
        params = net.device_params("cpu")
        h = net.apply_layer_range(params, xt, ptt, 0, 4)
        net32 = _port_tp_net(jnet.params)
        assert torch.equal(net.apply_layer_range(params, xt, ptt, 0, 1),
                           net32.apply_layer_range(params, xt, ptt, 0, 1))
        route = _port_tp_net(jnet.params, "bfloat16", None)
        h_route = route.apply_layer_range(params, xt, ptt, 0, 4)
    np.testing.assert_allclose(h.numpy(), want, rtol=0, atol=1e-6)
    assert (h - h_route).abs().max().item() > 1e-5


def test_validate_tp_message():
    """A mesh that does not divide a layer's cells per direction is
    refused in the JAX package's words."""
    jnet = JaxNetwork(NET_LAYERS)
    jnet.mesh = Mesh(np.asarray(jax.devices()[:3]), ("model",))
    with pytest.raises(ValueError) as want:
        jnet.validate_tp()
    net = Network(NET_LAYERS)
    net.model_mesh = [CPU] * 3
    with pytest.raises(ValueError, match=r"model_devices=3 must divide "
                       r"layer 'b1' cells per direction \(4\)") as got:
        net.validate_tp()
    assert str(got.value) == str(want.value)


def _heuristic_net(cls, sizes):
    layers = [{"name": "input", "type": "input", "size": 39}]
    for i, sz in enumerate(sizes):
        layers.append({"name": f"b{i}", "type": "blstm", "size": sz,
                       "bias": 1.0})
    layers += [{"name": "out", "type": "softmax", "size": 8, "bias": 1.0},
               {"name": "post", "type": "multiclass_classification",
                "size": 8}]
    return cls(layers)


@pytest.mark.parametrize("sizes, n", [([1024, 180], 12), ([1024, 512], 8),
                                      ([250, 250], 4), ([2048], 8)])
def test_auto_model_devices_matches_jax(monkeypatch, sizes, n):
    """--model_devices 0 against the JAX CLI's heuristic with each side's
    bound replaced by the same rule (cells per shard, rounded up to 128,
    at most 128: tests/test_cli.py:556-590), so that only the search is
    compared; on the CPU and the scan backend it is 1."""
    from lstm_rnn_tpu import cli as jax_cli
    from lstm_rnn_tpu.ops import lstm_cell as jax_lc
    from lstm_rnn_tpu_torch import cli
    from lstm_rnn_tpu_torch.ops import lstm_cell as lc
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jax_lc, "fused_fits",
                        lambda hp, pp, bp, dt, ch=1: hp <= 128)
    monkeypatch.setattr(lc, "recurrence_fits",
                        lambda h, dt, g: -(-h // 128) * 128 <= 128)
    want = jax_cli._auto_model_devices(_heuristic_net(JaxNetwork, sizes), 8,
                                       n)
    net = _heuristic_net(Network, sizes)
    assert cli._auto_model_devices(net, 8, n) == want
    assert cli._auto_model_devices(net, 8, n, "cpu") == 1


# ------------------------------------------------------------------ the CLI
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """tests/test_cli.py's --model_devices corpus (lengths 6, 5, 4, 7,
    seed 7) and net."""
    from tests.test_data import _write_classification_nc
    d = tmp_path_factory.mktemp("tp")
    _write_classification_nc(str(d / "train.nc"), [6, 5, 4, 7], in_size=3,
                             num_labels=4, seed=7)
    (d / "net.jsn").write_text(json.dumps({"layers": CLI_LAYERS}))
    return d


def _train_args(c, *extra):
    """tests/test_cli.py:276-279's flags, on the CPU."""
    return ["--network", str(c / "net.jsn"), "--train", "true",
            "--train_file", str(c / "train.nc"), "--stochastic", "true",
            "--learning_rate", "1e-3", "--parallel_sequences", "2",
            "--random_seed", "5", "--max_epochs", "2", "--device", "cpu",
            *extra]


@pytest.mark.parametrize("flags, banner", [
    (("--num_devices", "2", "--model_devices", "2"),
     "DP x TP mesh: {'data': 1, 'model': 2}"),
    (("--num_devices", "4", "--model_devices", "2"),
     "DP x TP mesh: {'data': 2, 'model': 2}"),
    (("--num_devices", "4", "--model_devices", "2", "--weight_noise_sigma",
      "0.05"), "DP x TP mesh: {'data': 2, 'model': 2}"),
], ids=["tp2", "dp_x_tp", "dp_x_tp_weight_noise"])
def test_cli_model_devices_matches_jax(corpus, tmp_path, capsys, flags,
                                       banner):
    """--model_devices 2 in train mode: with --num_devices 2 one process
    on a model mesh of the CPU twice, with --num_devices 4 two CPU workers
    over gloo, each with its own model mesh (DP x TP), with and without
    weight noise; against the JAX CLI's same run on its host devices: the
    JAX banner and the trained weights after 2 epochs."""
    args = _train_args(corpus, *flags)
    out = _port_ok(args, tmp_path / "port")
    assert banner in out
    _jax_ok(args, tmp_path / "jax")
    assert banner in capsys.readouterr().out
    _assert_weights_close(tmp_path / "port" / "trained_network.jsn",
                          tmp_path / "jax" / "trained_network.jsn")


def test_cli_model_devices_refusals(corpus, tmp_path, capsys):
    """The JAX CLI's refusals in its words: a model mesh that does not
    divide a layer's cells (rc 2, tests/test_cli.py:303-312), and, before
    any work, a --model_devices above 1 on one device or not dividing
    --num_devices."""
    from lstm_rnn_tpu import cli as jax_cli
    from lstm_rnn_tpu_torch import cli
    from lstm_rnn_tpu_torch.config import parse_config
    args = _train_args(corpus, "--num_devices", "8", "--model_devices", "8",
                       "--max_epochs", "1")
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        for main in (jax_cli.main, cli.main):
            assert main(args) == 2
            assert ("model_devices=8 must divide layer 'l1' cells per "
                    "direction (2)" in capsys.readouterr().out)
    finally:
        os.chdir(old)
    for argv, match in ((["--model_devices", "2"],
                         "model_devices > 1 requires num_devices > 1"),
                        (["--model_devices", "2", "--num_devices", "3"],
                         "model_devices=2 must divide num_devices=3")):
        with pytest.raises(ValueError, match=match):
            parse_config(["--network", "n.jsn", "--device", "cpu",
                          "--train", "true"] + argv)


def test_plan_of_dp_x_tp(monkeypatch):
    """A worker per model mesh in train mode: on 8 GPUs --num_devices 8
    --model_devices 4 is two workers on cuda:0 and cuda:4; n == k stays in
    this process; forward mode ignores --model_devices (no worker, as
    the JAX CLI's forward mode never reads it); a multi-host group that
    would span hosts is refused naming ROADMAP."""
    from lstm_rnn_tpu_torch.config import parse_config

    def plan(*argv, count=8):
        monkeypatch.setattr("torch.cuda.device_count", lambda: count)
        return launch.plan(parse_config(["--network", "n.jsn", *argv]),
                           torch.device("cuda", 0))
    p = plan("--train", "true", "--num_devices", "8", "--model_devices", "4")
    assert p.axis == "model" and p.devices == (torch.device("cuda", 0),
                                                torch.device("cuda", 4))
    assert p.meshes[1] == tuple(torch.device("cuda", j) for j in range(4, 8))
    assert plan("--train", "true", "--num_devices", "4", "--model_devices",
                "4") is None
    assert plan("--num_devices", "1", "--model_devices", "4") is None
    with pytest.raises(ValueError, match="model group across hosts"):
        plan("--train", "true", "--model_devices", "2",
             "--coordinator_address", "h:1", "--num_processes", "2",
             "--process_id", "0", count=3)
