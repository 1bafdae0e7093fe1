"""Data parallelism composed with sequence parallelism (DP x SP) and
data-parallel streaming in the port (parallel/mesh.py `composed_mesh`,
parallel/launch.py's plan of a worker per seq mesh, Trainer(seq_mesh=,
data_group=), the CLI's `--num_devices n --seq_devices sp`, its
multi-host flags with `--seq_devices`, and `--stream_chunk c
--num_devices k`) on the CPU: gloo between CPU worker processes, each
worker's seq mesh the CPU named sp times.

The port's runs are held against the JAX CLI's runs with the same flags
on its forced host devices (conftest gives this process 8; a two-process
JAX run gets 2 a process, as tests/test_distributed.py launches it) and
against the port's own run on one device, at the JAX tests' sizes (3
inputs, BLSTM(4), LSTM(3), softmax(4)). Bounds: trained weights within
the JAX tests' rtol=1e-5, atol=1e-7 after 2 epochs (tests/test_cli.py:
768-775, tests/test_distributed.py:159-165); served posteriors within
the same rtol=1e-5, atol=1e-7; a Trainer step's momentum delta within
1e-6 of its largest entry (only the order of f32 sums differs: blocks
into the leaf, then over the ranks).

This module imports no JAX package at its top: a spawned worker imports
it to find the functions it runs.
"""

import json
import os

import numpy as np
import pytest
import torch

from lstm_rnn_tpu_torch.parallel import launch
from lstm_rnn_tpu_torch.parallel import mesh as port_mesh
from tests.test_torch_data_parallel import (_assert_weights_close, _jax_ok,
                                            _multihost, _port, _port_ok)

CPU = torch.device("cpu")
# the JAX tests' net for DP x SP (tests/test_cli.py:733-775)
LAYERS = [
    {"name": "input", "type": "input", "size": 3},
    {"name": "l1", "type": "blstm", "size": 4, "bias": 1.0},
    {"name": "l2", "type": "lstm", "size": 3, "bias": 1.0},
    {"name": "output", "type": "softmax", "size": 4, "bias": 1.0},
    {"name": "postoutput", "type": "multiclass_classification", "size": 4}]
# tests/test_cli.py:_toy_setup's net, which streams (no BLSTM)
UNI_LAYERS = [LAYERS[0], {"name": "l1", "type": "lstm", "size": 4,
                          "bias": 1.0}] + LAYERS[3:]
# a Trainer step against one process: the momentum delta, relative
STEP_TOL = 1e-6
# served posteriors against the JAX CLI's and one device's
CSV_RTOL, CSV_ATOL = 1e-5, 1e-7


def _write_nc(path, lengths, seed):
    from tests.test_data import _write_classification_nc
    _write_classification_nc(str(path), lengths, in_size=3, num_labels=4,
                             seed=seed)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """tests/test_cli.py:733-775's corpus (lengths 6, 5, 4, 7, seed 17)
    and net, tests/test_distributed.py's corpus (seed 7, six sequences),
    and the streaming net with weights from a seed."""
    from lstm_rnn_tpu_torch.network import Network
    d = tmp_path_factory.mktemp("dpsp")
    _write_nc(d / "train.nc", [6, 5, 4, 7], 17)
    _write_nc(d / "dist.nc", [6, 5, 4, 7, 8, 3], 7)
    _write_nc(d / "stream.nc", [6, 5, 4, 7], 7)
    (d / "net.jsn").write_text(json.dumps({"layers": LAYERS}))
    # tests/test_distributed.py's net: BLSTM(4) -> softmax(4)
    (d / "dist.jsn").write_text(json.dumps({"layers": [
        LAYERS[0], LAYERS[1], LAYERS[3], LAYERS[4]]}))
    uni = Network(UNI_LAYERS)
    uni.init_params(3)
    uni.save(str(d / "uni.jsn"))
    served = Network(LAYERS)
    served.init_params(4)
    served.save(str(d / "served.jsn"))
    return d


def _train_args(c, *extra, nc="train.nc", net="net.jsn"):
    """tests/test_cli.py:759-762's flags, on the CPU."""
    return ["--network", str(c / net), "--train", "true",
            "--train_file", str(c / nc), "--stochastic", "true",
            "--learning_rate", "1e-3", "--parallel_sequences", "4",
            "--random_seed", "5", "--max_epochs", "2", "--device", "cpu",
            *extra]


_RUNS = {}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("dpsp_runs")


def _run(key, root, fn):
    """A run shared by several tests of the module: its directory."""
    if key not in _RUNS:
        d = root / f"run{len(_RUNS)}"
        os.makedirs(d)
        _RUNS[key] = (d, fn(d))
    return _RUNS[key]


def _port_train(c, root, *extra):
    return _run(("port",) + extra, root,
                lambda d: _port_ok(_train_args(c, *extra), d))


def _jax_train(c, root, *extra):
    return _run(("jax",) + extra, root,
                lambda d: _jax_ok(_train_args(c, *extra), d))


# ------------------------------------------------------- meshes and plans
def test_composed_mesh_on_the_cpu():
    """n / sp rank meshes of the CPU named sp times; n in (1, sp) is the
    one 1-D mesh; sp not dividing n is refused in the JAX words."""
    meshes, composed = port_mesh.composed_mesh(4, 2, "cpu")
    assert composed and meshes == [[CPU, CPU], [CPU, CPU]]
    for n in (1, 2):
        assert port_mesh.composed_mesh(n, 2, "cpu") == ([[CPU, CPU]],
                                                        False)
    with pytest.raises(ValueError, match="seq_devices=2 must divide "
                       "num_devices=3"):
        port_mesh.composed_mesh(3, 2, "cpu")


def test_composed_mesh_on_gpus(monkeypatch):
    """Rank j's group is cuda:j*sp .. cuda:j*sp+sp-1 (make_seq_mesh's
    offset); a group past the GPUs torch sees is refused."""
    monkeypatch.setattr(port_mesh.torch.cuda, "device_count", lambda: 8)
    meshes, composed = port_mesh.composed_mesh(8, 4)
    assert composed and meshes == [
        [torch.device("cuda", j) for j in range(4)],
        [torch.device("cuda", j) for j in range(4, 8)]]
    assert port_mesh.make_seq_mesh(2, offset=6) == [torch.device("cuda", 6),
                                                    torch.device("cuda", 7)]
    with pytest.raises(RuntimeError, match="num_devices=10 but only 8"):
        port_mesh.make_seq_mesh(2, offset=8)


def _plan(argv, device, count=None, monkeypatch=None):
    from lstm_rnn_tpu_torch.config import parse_config
    if count is not None:
        monkeypatch.setattr("torch.cuda.device_count", lambda: count)
    return launch.plan(parse_config(["--network", "n.jsn"] + argv), device)


def test_plan_of_dp_x_sp(monkeypatch):
    """A worker per seq mesh, its device the mesh's first: n / sp CPU
    workers on the CPU; on 8 GPUs, --num_devices 8 --seq_devices 2 is four
    workers on cuda:0, 2, 4, 6, and --num_devices 0 --seq_devices 4 two;
    a multi-host process counts its local seq groups, and one CPU worker
    with the CPU sp times; ranks stay process-major."""
    p = _plan(["--device", "cpu", "--num_devices", "4", "--seq_devices",
               "2"], CPU)
    assert p.devices == (CPU, CPU) and p.meshes == ((CPU, CPU),) * 2
    cuda = torch.device("cuda", 0)
    p = _plan(["--num_devices", "8", "--seq_devices", "2"], cuda, 8,
              monkeypatch)
    assert p.devices == tuple(torch.device("cuda", j) for j in (0, 2, 4, 6))
    assert p.meshes[3] == (torch.device("cuda", 6), torch.device("cuda", 7))
    assert _plan(["--num_devices", "0", "--seq_devices", "4"], cuda, 8,
                 monkeypatch).world == 2
    mh = ["--coordinator_address", "h:1", "--num_processes", "2",
          "--process_id", "1", "--seq_devices", "2"]
    p = _plan(mh, cuda, 4, monkeypatch)
    assert p.world == 4 and p.process_id == 1 and len(p.meshes) == 2
    p = _plan(mh, cuda, 2, monkeypatch)
    assert p.world == 2 and p.meshes == ((cuda, torch.device("cuda", 1)),)
    p = _plan(mh + ["--device", "cpu"], CPU)
    assert p.world == 2 and p.meshes == ((CPU, CPU),)


@pytest.mark.parametrize("argv, error, match", [
    (["--num_devices", "3", "--seq_devices", "2", "--device", "cpu"],
     ValueError, "seq_devices=2 must divide num_devices=3"),
    (["--num_devices", "6", "--seq_devices", "4", "--device", "cpu"],
     ValueError, "seq_devices=4 must divide num_devices=6"),
    (["--num_devices", "4", "--seq_devices", "2", "--device", "cuda"],
     RuntimeError, "num_devices=4 but only 1 devices available"),
    (["--seq_devices", "2", "--coordinator_address", "h:1",
      "--num_processes", "2", "--process_id", "0", "--device", "cuda"],
     ValueError, "seq group across hosts.*ROADMAP"),
], ids=["3_over_2", "6_over_4", "too_few_gpus", "cross_host_group"])
def test_dp_x_sp_refusals(monkeypatch, argv, error, match):
    """sp not dividing n, in the JAX words (config.py); more GPUs than
    torch sees, in the JAX CLI's words; a seq group that would span hosts
    (sp = 2 over a host of 3 GPUs), naming ROADMAP (launch.plan)."""
    count = 3 if "h:1" in argv else 1
    with pytest.raises(error, match=match):
        _plan(argv, torch.device("cuda", 0), count, monkeypatch)


# ------------------------------------------------------------- the Trainer
def _trainer(group=None, mesh=None, train=None, stochastic=True,
             skip_reduce=False):
    from lstm_rnn_tpu_torch.network import Network
    from lstm_rnn_tpu_torch.trainer import Trainer
    net = Network(LAYERS)
    net.init_params(5)
    tr = Trainer(net, train, learning_rate=1e-2, momentum=0.9, max_epochs=1,
                 hybrid_online_batch=stochastic, device=None if group
                 else "cpu", seq_mesh=mesh, data_group=group)
    if skip_reduce:
        tr._sum_over_ranks = lambda tensors: None
    return tr


def _step_batch():
    """One fraction of 5 rows (T = 7: padded to 8 for 2 blocks; lengths
    1..7, the last row empty): over 2 ranks B pads to 6, the pad row on
    rank 1."""
    rng = np.random.RandomState(21)
    T, b = 7, 5
    lengths = np.array([7, 3, 6, 1, 0])
    pt = (np.arange(T)[:, None] < lengths[None, :]).astype(np.int8)
    tc = np.where(pt > 0, rng.randint(0, 4, (T, b)), -1).astype(np.int32)
    return rng.randn(T, b, 3).astype(np.float32), tc, pt


def _dataset(nc):
    from lstm_rnn_tpu_torch.data.dataset import DataSet
    return DataSet([nc], parallel_sequences=3, seed=5, prefetch=False)


def _trainer_worker(group, out_dir, how, nc):
    """`how` on this rank (a seq mesh of the CPU twice): "step" one SGD
    step on its block of _step_batch; "stochastic"/"batch" one epoch of
    its blocks of the corpus (3 sequences a fraction over 2 ranks); the
    "no all-reduce" control the step without the gradient sum. Saves
    the losses, counts, parameters and momentum deltas."""
    stochastic = how != "batch"
    train = None if how in ("step", "no all-reduce") else _dataset(nc)
    tr = _trainer(group, list(group.seq_mesh), train, stochastic,
                  how == "no all-reduce")
    out = {}
    if train is None:
        blk = [torch.from_numpy(a) for a in group.block(*_step_batch())]
        err, corr = tr.train_step(*blk)
        out.update(err=err.item(), corr=int(corr))
    else:
        tr.train_epoch()
        out.update(err=tr.cur_training_error,
                   corr=tr.cur_training_class_error)
    out.update(params=tr.exact_params(), v=tr.exact_params(tr.velocity))
    torch.save(out, os.path.join(out_dir, f"rank{group.rank}.pt"))


def _tree_rel(got, want):
    return max(float(np.abs(got[n][k] - want[n][k]).max())
               for n in want for k in want[n]) / max(
        float(np.abs(want[n][k]).max()) for n in want for k in want[n])


@pytest.mark.parametrize("how", ["step", "stochastic", "batch",
                                 "no all-reduce"])
def test_trainer_dp_x_sp_matches_one_process(corpus, tmp_path, how):
    """Trainer(seq_mesh=, data_group=) on 2 ranks x 2 blocks against one
    process without a mesh: one stochastic step (the ranks' losses and
    counts summed), and one epoch stochastic and batch over the corpus
    (3 sequences a fraction: the last fraction's one sequence leaves
    rank 1 all padding); the momentum deltas within STEP_TOL, the ranks'
    weights equal. The control leaves the all-reduce out and must
    differ."""
    nc = str(corpus / "train.nc")
    step = how in ("step", "no all-reduce")
    one = _trainer(None, None, None if step else _dataset(nc),
                   how != "batch")
    if step:
        err, corr = one.train_step(*(torch.from_numpy(a)
                                     for a in _step_batch()))
        err, corr = err.item(), int(corr)
    else:
        one.train_epoch()
        err, corr = one.cur_training_error, one.cur_training_class_error
    want_v = one.exact_params(one.velocity)
    launch.start(_trainer_worker, [[CPU, CPU]] * 2,
                 (str(tmp_path), how, nc))
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    rel = max(_tree_rel(r["v"], want_v) for r in ranks)
    if how == "no all-reduce":
        assert rel > STEP_TOL
        return
    assert rel <= STEP_TOL, rel
    for r in ranks[1:]:
        assert all(np.array_equal(r["params"][n][k], ranks[0]["params"][n][k])
                   for n in want_v for k in want_v[n])
    if step:
        assert abs(sum(r["err"] for r in ranks) - err) <= 1e-6 * abs(err)
        assert sum(r["corr"] for r in ranks) == corr
    else:  # the pass's metrics are summed over the ranks already
        for r in ranks:
            assert abs(r["err"] - err) <= 1e-6 * abs(err)
            assert r["corr"] == corr


def test_trainer_takes_the_mesh_first_device():
    """Trainer(seq_mesh=, data_group=) trains on the mesh's first device,
    the group's, with the unfused tail (the SP route)."""
    from lstm_rnn_tpu_torch.parallel.data import DataGroup
    group = DataGroup(0, 2, CPU, seq_mesh=(CPU, CPU))
    tr = _trainer(group, [CPU, CPU])
    assert tr.device == CPU and tr.seq_mesh == [CPU, CPU]
    assert tr.data_group is group and not tr.fused_tail


# ------------------------------------------------------------ CLI training
@pytest.mark.parametrize("extra", [
    (), ("--stochastic", "false"), ("--parallel_sequences", "3"),
    ("--weight_noise_sigma", "0.05"),
], ids=["stochastic", "batch", "non_dividing", "weight_noise"])
def test_cli_dp_x_sp_matches_jax_and_one_device(corpus, root, extra):
    """--num_devices 4 --seq_devices 2 (2 CPU workers, each a 2-block seq
    mesh) against the JAX CLI's same run on its host devices (tests/
    test_cli.py:733-775) and the port's one-device run: the trained
    weights after 2 epochs. Batch mode (one all-reduce a pass),
    parallel_sequences 3 (B pads to 4: the second fraction's one sequence
    leaves rank 1 all padding) and weight noise (every rank draws the same
    stream) too."""
    flags = ("--num_devices", "4", "--seq_devices", "2")
    d, out = _port_train(corpus, root, *extra, *flags)
    assert "DP x SP mesh: {'data': 2, 'seq': 2}" in out
    assert "Sequence-parallel mesh" not in out
    _assert_weights_close(d / "trained_network.jsn",
                          _port_train(corpus, root, *extra)[0]
                          / "trained_network.jsn")
    _assert_weights_close(d / "trained_network.jsn",
                          _jax_train(corpus, root, *extra, *flags)[0]
                          / "trained_network.jsn")


def test_cli_dp_x_sp_continue_equals_straight_run(corpus, tmp_path):
    """A DP x SP run resumed from its epoch-1 autosave ends with the
    uninterrupted run's weights (the stored configuration carries both
    flags)."""
    args = _train_args(corpus, "--num_devices", "4", "--seq_devices", "2",
                       "--max_epochs", "2", "--autosave", "true",
                       "--shuffle_fractions", "true")
    _port_ok(args, tmp_path / "straight")
    out = _port_ok(["--continue", str(tmp_path / "straight" /
                                      "epoch001.autosave")],
                   tmp_path / "resumed")
    assert "DP x SP mesh: {'data': 2, 'seq': 2}" in out
    _assert_weights_close(tmp_path / "resumed" / "trained_network.jsn",
                          tmp_path / "straight" / "trained_network.jsn")


def test_multihost_dp_x_sp_matches_jax_and_num_devices(corpus, root):
    """Two port processes with the multi-host flags and --seq_devices 2
    (each one CPU worker on a 2-block mesh: a ('data': 2, 'seq': 2) run)
    against the JAX CLI's two processes of 2 host devices each (tests/
    test_distributed.py:124-165, on its corpus and flags) and the
    port's --num_devices 4 --seq_devices 2; process 1 prints and writes
    nothing."""
    from tests.test_distributed import _cli_env
    extra = ("--fuse_fractions", "4", "--bucket_lengths", "true")
    args = _train_args(corpus, *extra, "--seq_devices", "2", nc="dist.nc",
                       net="dist.jsn")
    dirs = [root / "mh0", root / "mh1"]
    outs = _multihost(args, dirs)
    assert "DP x SP mesh: {'data': 2, 'seq': 2}" in outs[0]
    assert "Starting training" not in outs[1]
    assert os.listdir(dirs[1]) == []
    jax_dirs = [root / "jax_mh0", root / "jax_mh1"]
    outs = _multihost(args, jax_dirs, "lstm_rnn_tpu.cli", _cli_env(2))
    assert "DP x SP mesh" in outs[0]
    _assert_weights_close(dirs[0] / "trained_network.jsn",
                          jax_dirs[0] / "trained_network.jsn")
    one = root / "mh_num_devices"
    _port_ok(args + ["--num_devices", "4"], one)
    _assert_weights_close(dirs[0] / "trained_network.jsn",
                          one / "trained_network.jsn")


# ------------------------------------------------------------- CLI serving
def _assert_csv_close(a, b, n):
    la = open(a).read().strip().split("\n")
    lb = open(b).read().strip().split("\n")
    assert len(la) == len(lb) == n
    for x, y in zip(la, lb):
        ca, cb = x.split(";"), y.split(";")
        assert ca[0] == cb[0]
        np.testing.assert_allclose([float(v) for v in ca[1:]],
                                   [float(v) for v in cb[1:]],
                                   rtol=CSV_RTOL, atol=CSV_ATOL)


def _serve(c, net, nc, tmp_path, name, *extra, ps=3):
    return ["--network", str(c / net), "--train", "false",
            "--ff_input_file", str(c / nc), "--ff_output_format",
            "single_csv", "--parallel_sequences", str(ps), "--device", "cpu",
            "--ff_output_file", str(tmp_path / f"{name}.csv"), *extra]


@pytest.mark.parametrize("ps", [4, 3])
def test_dp_x_sp_serving_matches_jax_and_one_device(corpus, tmp_path, ps):
    """--train false --num_devices 4 --seq_devices 2 writes the port's
    one-device posteriors, and at parallel_sequences 4 the JAX CLI's for
    the same flags (its serving shards B without padding it: 3 rows over
    2 shards fail there). At parallel_sequences 3, B pads to 4 and the
    second fraction leaves rank 1 all padding."""
    flags = ("--num_devices", "4", "--seq_devices", "2")
    out = _port_ok(_serve(corpus, "served.jsn", "train.nc", tmp_path, "port",
                          *flags, ps=ps), tmp_path / "p")
    assert "DP x SP mesh: {'data': 2, 'seq': 2}" in out
    _port_ok(_serve(corpus, "served.jsn", "train.nc", tmp_path, "one",
                    ps=ps), tmp_path / "o")
    _assert_csv_close(tmp_path / "port.csv", tmp_path / "one.csv", 4)
    if ps % 2 == 0:
        _jax_ok(_serve(corpus, "served.jsn", "train.nc", tmp_path, "jax",
                       *flags, ps=ps), tmp_path / "j")
        _assert_csv_close(tmp_path / "port.csv", tmp_path / "jax.csv", 4)


def test_dp_streaming_matches_jax_and_one_device(corpus, tmp_path):
    """--stream_chunk 3 --num_devices 2 --parallel_sequences 3 (tests/
    test_cli.py:888-907: B pads to 4, two streams a rank, rank 1 all
    padding in the second fraction; the last chunk of a fraction
    shorter) writes the JAX CLI's posteriors for the same flags and the
    port's one-device streamed ones."""
    flags = ("--stream_chunk", "3")
    out = _port_ok(_serve(corpus, "uni.jsn", "stream.nc", tmp_path, "port",
                          *flags, "--num_devices", "2"), tmp_path / "p")
    assert "Data-parallel streaming mesh: {'data': 2}" in out
    _jax_ok(_serve(corpus, "uni.jsn", "stream.nc", tmp_path, "jax", *flags,
                   "--num_devices", "2"), tmp_path / "j")
    _port_ok(_serve(corpus, "uni.jsn", "stream.nc", tmp_path, "one",
                    *flags), tmp_path / "o")
    _assert_csv_close(tmp_path / "port.csv", tmp_path / "jax.csv", 4)
    _assert_csv_close(tmp_path / "port.csv", tmp_path / "one.csv", 4)


def test_all_padding_rank_streams_zeros(corpus):
    """A rank whose rows are all padding (PATTYPE_NONE) streams exactly
    zero LSTM outputs and carries an exactly zero state, chunk after
    chunk; the real row's outputs are those of the unpadded batch within
    1e-6."""
    from lstm_rnn_tpu_torch.network import Network
    from lstm_rnn_tpu_torch.parallel.data import pad_batch
    net = Network.from_json_file(str(corpus / "uni.jsn"))
    params = net.device_params("cpu")
    rng = np.random.RandomState(8)
    x = rng.randn(7, 1, 3).astype(np.float32)
    pt = np.ones((7, 1), np.int8)
    xp, _, ptp = pad_batch(x, None, pt, 4)
    outs = {}
    for name, (xs, ps) in (("padded", (xp, ptp)), ("one", (x, pt))):
        xs, ps = torch.from_numpy(xs), torch.from_numpy(ps)
        state = net.init_stream_state(xs.shape[1], "cpu")
        ys = []
        for lo in range(0, 7, 3):
            y, state = net._apply_layers(params, xs[lo:lo + 3],
                                         ps[lo:lo + 3], net.specs[1:-2],
                                         state)
            ys.append(y)
            if name == "padded":
                assert all(not s[:, 1:].any() for s in state["l1"])
        outs[name] = torch.cat(ys)
    assert not outs["padded"][:, 1:].any()
    # the real row against the unpadded batch: f32 products over 4 rows
    # against 1 may sum in another order
    torch.testing.assert_close(outs["padded"][:, :1], outs["one"], rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("extra", [("--seq_devices", "2"),
                                   ("--stream_chunk", "3")])
def test_multihost_seq_and_streaming_serving_refused(corpus, tmp_path,
                                                     extra):
    """Sequence-parallel and streaming serving over several hosts are
    refused up front with the JAX CLI's RuntimeError (lstm_rnn_tpu/cli.py:
    538-546), before any worker or rendezvous: one process alone gets it
    at once."""
    from lstm_rnn_tpu_torch import cli
    from lstm_rnn_tpu_torch.config import parse_config
    args = _serve(corpus, "uni.jsn", "stream.nc", tmp_path, "x", *extra,
                  "--coordinator_address", "127.0.0.1:1",
                  "--num_processes", "2", "--process_id", "0")
    with pytest.raises(RuntimeError, match="single-host"):
        cli._check_servable(parse_config(args))
    rc, out, _ = _port(args, tmp_path, timeout=60)
    assert rc == 2 and "single-host" in out
    assert "Computing outputs" not in out and not os.listdir(tmp_path)


def test_dp_streaming_refuses_blstm_before_workers(corpus, tmp_path):
    """--stream_chunk with --num_devices 2 on a BLSTM net fails in the
    launching process with the layer's ValueError, before any worker."""
    rc, out, err = _port(_serve(corpus, "served.jsn", "stream.nc", tmp_path,
                                "x", "--stream_chunk", "3", "--num_devices",
                                "2"), tmp_path, timeout=60)
    assert rc == 2 and "'l1' is bidirectional" in out
    assert "rank " not in out and "Computing outputs" not in out
