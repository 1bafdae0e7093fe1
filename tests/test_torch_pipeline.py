"""Pipeline parallelism in the port (lstm_rnn_tpu_torch.parallel.pipeline:
stage_ranges, loss_and_count_pipelined, apply_pipelined;
Trainer(pipe_mesh=); the CLI's --pipeline_devices, alone and as DP x PP)
against the JAX package's, on the same numpy inputs and weights.

The port's pipe mesh is the CPU named k times (one process, every stage
on the CPU); the JAX side runs on its forced host devices (tests/
conftest.py). Tolerances are the JAX package's own for its pipeline
against its one-device net (tests/test_pipeline.py): the loss rtol 1e-6,
every gradient rtol 2e-5 / atol 1e-6; trained weights after 2 epochs and
served posteriors rtol 1e-5 / atol 1e-7 (tests/test_cli.py:596-690). The
port's last stage takes the fused tail (its twins on the CPU) where the
JAX pipeline takes the unfused loss: the two differ by f32 reduction
order only.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lstm_rnn_tpu.network import Network as JaxNetwork
from lstm_rnn_tpu.ops.masking import pattypes_from_lengths
from lstm_rnn_tpu.parallel import pipeline as jax_pp
from lstm_rnn_tpu.parallel.mesh import make_mesh
from lstm_rnn_tpu_torch.network import Network
from lstm_rnn_tpu_torch.parallel import launch
from lstm_rnn_tpu_torch.parallel import mesh as port_mesh
from lstm_rnn_tpu_torch.parallel.pipeline import (apply_pipelined,
                                                  loss_and_count_pipelined,
                                                  stage_ranges)
from tests.test_cli import _assert_csv_close
from tests.test_pipeline import LAYERS
from tests.test_torch_data_parallel import (_assert_weights_close, _jax_ok,
                                            _port, _port_ok)

CPU = torch.device("cpu")
LOSS_RTOL = 1e-6
GRAD_RTOL, GRAD_ATOL = 2e-5, 1e-6
CSV_RTOL, CSV_ATOL = 1e-5, 1e-7
# tests/test_cli.py:596-623's net for --pipeline_devices
CLI_LAYERS = [
    {"name": "input", "type": "input", "size": 3},
    {"name": "l1", "type": "blstm", "size": 4, "bias": 1.0},
    {"name": "ff", "type": "feedforward_tanh", "size": 5, "bias": 0.5},
    {"name": "l2", "type": "lstm", "size": 3, "bias": 1.0},
    {"name": "output", "type": "softmax", "size": 4, "bias": 1.0},
    {"name": "postoutput", "type": "multiclass_classification", "size": 4}]


# ------------------------------------------------------------ stage ranges
@pytest.mark.parametrize("n_layers", range(1, 8))
def test_stage_ranges_match_jax(n_layers):
    """Every stage count up to the layer count gives the JAX ranges
    (numpy's half-to-even rounding: 6 layers over 4 stages give (0, 2),
    (2, 3), (3, 4), (4, 6)); one stage more is refused in the JAX
    words."""
    for k in range(1, n_layers + 1):
        assert stage_ranges(n_layers, k) == jax_pp.stage_ranges(n_layers, k)
    assert stage_ranges(6, 4) == [(0, 2), (2, 3), (3, 4), (4, 6)]
    with pytest.raises(ValueError) as want:
        jax_pp.stage_ranges(n_layers, n_layers + 1)
    with pytest.raises(ValueError, match="exceeds") as got:
        stage_ranges(n_layers, n_layers + 1)
    assert str(got.value) == str(want.value)


# --------------------------------------------------- loss, count, gradients
def _batch(b, t=7, seed=1234):
    """tests/test_pipeline.py's batch: half the rows full, half 2 short."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (t, b, 3)).astype(np.float32)
    lens = [t] * (b // 2) + [max(1, t - 2)] * (b - b // 2)
    pt = np.asarray(pattypes_from_lengths(lens, t, b))
    tc = rng.randint(0, 4, (t, b)).astype(np.int32)
    return x, tc, pt


@functools.lru_cache(maxsize=None)
def _jax_pipelined(b, n, m):
    jnet = JaxNetwork(LAYERS)
    jnet.init_params(11)
    params = jax.tree_util.tree_map(jnp.asarray, jnet.params)
    x, tc, pt = map(jnp.asarray, _batch(b))
    mesh = make_mesh(n, axis="pipe")

    def pipe(p):
        return jax_pp.loss_and_count_pipelined(jnet, p, x, tc, pt, mesh,
                                               microbatches=m)

    (err, corr), grads = jax.jit(jax.value_and_grad(pipe, has_aux=True))(
        params)
    y = jax.jit(lambda p: jax_pp.apply_pipelined(
        jnet, p, x, pt, mesh, microbatches=m))(params)
    return (jnet.params, float(err), int(corr),
            jax.tree_util.tree_map(np.asarray, grads), np.asarray(y))


def _port_pipelined(net, n, m, b):
    params = net.device_params("cpu")
    leaves = [v.requires_grad_(True) for layer in params.values()
              for v in layer.values()]
    x, tc, pt = map(torch.from_numpy, _batch(b))
    mesh = port_mesh.make_seq_mesh(n, "cpu")
    err, corr = loss_and_count_pipelined(net, params, x, tc, pt, mesh, m)
    grads = torch.autograd.grad(err, leaves)
    it = iter(grads)
    tree = {name: {k: next(it).numpy() for k in layer}
            for name, layer in params.items()}
    with torch.inference_mode():
        y = apply_pipelined(net, params, x, pt, mesh, m)
    return err.item(), int(corr), tree, y.numpy()


@pytest.mark.parametrize("backend", ["auto", "scan"])
@pytest.mark.parametrize("b, n, m", [(8, 2, 0), (8, 3, 0), (7, 2, 0),
                                     (8, 2, 4)],
                         ids=["pp2", "pp3", "ragged", "m4"])
def test_pipelined_matches_jax(monkeypatch, backend, b, n, m):
    """loss_and_count_pipelined (loss, count, every gradient) and
    apply_pipelined against the JAX package's on the same pipe mesh size:
    2 and 3 stages, a ragged batch (B = 7 over 2 microbatches: one
    PATTYPE_NONE column) and more microbatches than stages. Backend
    "auto" ends the last stage with the fused tail (the K3 twins), which
    must run twice per microbatch (its forward, then its recompute under
    the stage's checkpoint); "scan" with the unfused loss, the JAX
    pipeline's."""
    params_np, e_want, c_want, g_want, y_want = _jax_pipelined(b, n, m)
    net = Network(LAYERS, backend=backend)
    net.params = params_np
    calls = []
    tail = net.fused_tail
    monkeypatch.setattr(net, "fused_tail",
                        lambda *a: calls.append(1) or tail(*a))
    err, corr, grads, y = _port_pipelined(net, n, m, b)
    assert len(calls) == (0 if backend == "scan" else 2 * (m or n))
    np.testing.assert_allclose(err, e_want, rtol=LOSS_RTOL)
    assert corr == c_want
    for name in g_want:
        for k in g_want[name]:
            np.testing.assert_allclose(grads[name][k], g_want[name][k],
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=f"{name}/{k}")
    assert y.shape == y_want.shape == (7, b, 4)
    np.testing.assert_allclose(y, y_want, rtol=1e-5, atol=1e-6)


def test_pipelined_controls_fail():
    """The loss check above has the power to catch a broken schedule: a
    microbatch dropped (microbatch 1 of 2 never reaching the loss) or the
    microbatches' targets swapped between them move the loss far outside
    LOSS_RTOL."""
    params_np, e_want, _, _, _ = _jax_pipelined(8, 2, 0)
    net = Network(LAYERS)
    net.params = params_np
    params = net.device_params("cpu")
    x, tc, pt = map(torch.from_numpy, _batch(8))
    dropped, _ = loss_and_count_pipelined(net, params, x[:, :4], tc[:, :4],
                                          pt[:, :4], [CPU, CPU], 1)
    swapped, _ = loss_and_count_pipelined(
        net, params, x, torch.cat([tc[:, 4:], tc[:, :4]], dim=1), pt,
        [CPU, CPU])
    for err in (dropped, swapped):
        assert abs(err.item() - e_want) > 10 * LOSS_RTOL * abs(e_want)


def test_trainer_pipe_mesh_checks_stages():
    """Trainer(pipe_mesh=) trains on the mesh's first device with the
    fused tail on its last stage, and refuses more stages than hidden
    layers in the JAX words before any step."""
    from lstm_rnn_tpu_torch.trainer import Trainer
    net = Network(LAYERS)
    net.init_params(3)
    tr = Trainer(net, None, pipe_mesh=[CPU, CPU], pipeline_microbatches=3)
    assert tr.device == CPU and tr.fused_tail and tr.mesh_devices == [CPU,
                                                                      CPU]
    with pytest.raises(ValueError, match="pipeline_devices=5 exceeds the 4 "
                       "hidden layers"):
        Trainer(net, None, pipe_mesh=[CPU] * 5)


# ------------------------------------------------------------------ the CLI
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """tests/test_cli.py's pipeline corpus (lengths 6, 5, 4, 7, seed 9),
    its DP x PP corpus (seed 13), its net and a trained-looking net for
    serving."""
    from tests.test_data import _write_classification_nc
    d = tmp_path_factory.mktemp("pp")
    for name, seed in (("train.nc", 9), ("dpp.nc", 13)):
        _write_classification_nc(str(d / name), [6, 5, 4, 7], in_size=3,
                                 num_labels=4, seed=seed)
    (d / "net.jsn").write_text(json.dumps({"layers": CLI_LAYERS}))
    served = Network(CLI_LAYERS)
    served.init_params(4)
    served.save(str(d / "served.jsn"))
    return d


def _train_args(c, *extra, nc="train.nc", ps="2"):
    """tests/test_cli.py:622-625's flags, on the CPU."""
    return ["--network", str(c / "net.jsn"), "--train", "true",
            "--train_file", str(c / nc), "--stochastic", "true",
            "--learning_rate", "1e-3", "--parallel_sequences", ps,
            "--random_seed", "5", "--max_epochs", "2", "--device", "cpu",
            *extra]


def _port_in_process(args, cwd, capsys):
    from lstm_rnn_tpu_torch import cli
    os.makedirs(cwd, exist_ok=True)
    old = os.getcwd()
    os.chdir(cwd)
    try:
        assert cli.main(list(args)) == 0
    finally:
        os.chdir(old)
    return capsys.readouterr().out


_JAX_RUNS = {}


@pytest.mark.parametrize("extra, jax_extra", [
    ((), ()), (("--pipeline_microbatches", "3"), ()),
    (("--remat_blocks", "2"), ("--remat_blocks", "2"))],
    ids=["m2", "m3", "remat"])
def test_cli_pipeline_training_matches_jax(corpus, tmp_path_factory, capsys,
                                           extra, jax_extra):
    """--pipeline_devices 2 in train mode (one process, the CPU twice)
    against the JAX CLI's run: the JAX banner and the trained weights
    after 2 epochs; with --remat_blocks 2 inside the stages against the
    JAX CLI's run with it, and with 3 microbatches against the JAX run of
    2 (the microbatch count moves f32 sums only, tests/test_pipeline.py:
    150-161)."""
    args = _train_args(corpus, "--pipeline_devices", "2")
    banner = "Pipeline mesh: {'pipe': 2} (4 hidden layers over 2 stages)"
    d = tmp_path_factory.mktemp("pp_cli")
    assert banner in _port_in_process(args + list(extra), d / "port", capsys)
    if jax_extra not in _JAX_RUNS:
        _JAX_RUNS[jax_extra] = tmp_path_factory.mktemp("pp_jax")
        _jax_ok(args + list(jax_extra), _JAX_RUNS[jax_extra])
        assert banner in capsys.readouterr().out
    _assert_weights_close(d / "port" / "trained_network.jsn",
                          _JAX_RUNS[jax_extra] / "trained_network.jsn")


def _serve_args(c, out, *extra):
    return ["--network", str(c / "served.jsn"), "--train", "false",
            "--ff_input_file", str(c / "train.nc"), "--ff_output_format",
            "single_csv", "--ff_output_file", str(out), "--device", "cpu",
            *extra]


def test_cli_pipeline_serving_matches_jax(corpus, tmp_path, capsys):
    """--pipeline_devices 2 in forward mode against the JAX CLI's same
    run and the port's one-device run: the banner and the posteriors."""
    pp = ("--pipeline_devices", "2")
    out = _port_in_process(_serve_args(corpus, tmp_path / "pp.csv", *pp),
                           tmp_path, capsys)
    assert "Pipeline mesh: {'pipe': 2}" in out
    _port_in_process(_serve_args(corpus, tmp_path / "one.csv"), tmp_path,
                     capsys)
    _jax_ok(_serve_args(corpus, tmp_path / "jax.csv", *pp), tmp_path)
    for want in ("one.csv", "jax.csv"):
        _assert_csv_close(tmp_path / "pp.csv", tmp_path / want,
                          rtol=CSV_RTOL, atol=CSV_ATOL)


def test_cli_dp_x_pp_matches_jax(corpus, tmp_path, capsys):
    """--num_devices 4 --pipeline_devices 2: two CPU workers over gloo,
    each a 2-stage pipe mesh of the CPU, in train mode against the JAX
    CLI's run on its 2-D ('data', 'pipe') mesh (tests/test_cli.py:
    642-684: parallel_sequences 4), and in forward mode against the port's
    one-device posteriors; the JAX banner in both."""
    flags = ("--num_devices", "4", "--pipeline_devices", "2")
    args = _train_args(corpus, *flags, nc="dpp.nc", ps="4")
    out = _port_ok(args, tmp_path / "port")
    assert "DP x PP mesh: {'data': 2, 'pipe': 2}" in out
    _jax_ok(args, tmp_path / "jax")
    assert "DP x PP mesh: {'data': 2, 'pipe': 2}" in capsys.readouterr().out
    _assert_weights_close(tmp_path / "port" / "trained_network.jsn",
                          tmp_path / "jax" / "trained_network.jsn")
    out = _port_ok(_serve_args(corpus, tmp_path / "dpp.csv", *flags),
                   tmp_path)
    assert "DP x PP mesh: {'data': 2, 'pipe': 2}" in out
    _port_in_process(_serve_args(corpus, tmp_path / "one.csv"), tmp_path,
                     capsys)
    _assert_csv_close(tmp_path / "dpp.csv", tmp_path / "one.csv",
                      rtol=CSV_RTOL, atol=CSV_ATOL)


def test_plan_of_dp_x_pp(monkeypatch):
    """A worker per pipe mesh: on the CPU n / k workers with the CPU k
    times; on 8 GPUs --num_devices 8 --pipeline_devices 2 is four workers
    on cuda:0, 2, 4, 6 with their pipe meshes; n == k stays in this
    process; a multi-host process counts its local groups and refuses one
    that would span hosts."""
    from lstm_rnn_tpu_torch.config import parse_config

    def plan(*argv, count=8, device="cuda"):
        monkeypatch.setattr("torch.cuda.device_count", lambda: count)
        return launch.plan(parse_config(["--network", "n.jsn", *argv]),
                           torch.device(device))
    p = plan("--num_devices", "4", "--pipeline_devices", "2", device="cpu")
    assert p.axis == "pipe" and p.meshes == ((CPU, CPU),) * 2
    p = plan("--num_devices", "8", "--pipeline_devices", "2")
    assert p.devices == tuple(torch.device("cuda", j) for j in (0, 2, 4, 6))
    assert p.meshes[1] == (torch.device("cuda", 2), torch.device("cuda", 3))
    assert plan("--num_devices", "2", "--pipeline_devices", "2") is None
    mh = ("--coordinator_address", "h:1", "--num_processes", "2",
          "--process_id", "0", "--pipeline_devices", "2")
    assert plan(*mh, count=4).world == 4
    with pytest.raises(ValueError, match="pipe group across hosts.*ROADMAP"):
        plan(*mh, count=3)


@pytest.mark.parametrize("argv, match", [
    (["--train", "true", "--pipeline_devices", "2", "--model_devices",
      "2", "--num_devices", "2"],
     "pipeline_devices > 1 does not combine with model_devices"),
    (["--pipeline_devices", "2", "--stream_chunk", "4"],
     "stream_chunk does not combine with pipeline_devices or seq_devices"),
    (["--num_devices", "3", "--pipeline_devices", "2"],
     "pipeline_devices=2 must divide num_devices=3"),
    (["--pipeline_devices", "2", "--seq_devices", "2"],
     "seq_devices > 1 does not combine with model_devices or "
     "pipeline_devices"),
], ids=["with_tp", "stream_chunk", "not_dividing", "with_sp"])
def test_config_refuses_pipeline_combinations(argv, match):
    """The JAX CLI's refusals (lstm_rnn_tpu/cli.py:338-340, :580-586,
    parallel/mesh.py:87-90), in its words, before any work."""
    from lstm_rnn_tpu_torch.config import parse_config
    with pytest.raises(ValueError, match=match):
        parse_config(["--network", "n.jsn", "--device", "cpu"] + argv)


def test_cli_refuses_stages_and_multihost_serving(corpus, tmp_path, capsys):
    """More stages than hidden layers fail with rc 2 and the JAX message
    before any fraction (tests/test_cli.py:724-730), in the port's CLI as
    in the JAX CLI; multi-host pipelined serving is refused in the JAX
    words."""
    from lstm_rnn_tpu import cli as jax_cli
    from lstm_rnn_tpu_torch import cli
    args = _serve_args(corpus, tmp_path / "c.csv", "--pipeline_devices", "5")
    for main in (jax_cli.main, cli.main):
        assert main(args) == 2
        out, err = capsys.readouterr()
        assert "pipeline_devices=5 exceeds the 4 hidden layers" in out + err
        assert "Computing outputs" not in out
    rc, out, _ = _port(_serve_args(
        corpus, tmp_path / "d.csv", "--pipeline_devices", "2",
        "--coordinator_address", "127.0.0.1:1", "--num_processes", "2",
        "--process_id", "0"), tmp_path)
    assert rc == 2
    assert "pipeline/seq/streaming serving is single-host" in out
