"""Data parallelism of the port (parallel/data.py, parallel/launch.py,
Trainer(data_group=), the CLI's --num_devices k and multi-host flags) on
the CPU: gloo between CPU worker processes, at the size of
tests/test_distributed.py (3 inputs -> BLSTM(4) -> softmax(4), corpus
seed 7).

The port's runs are held against the JAX CLI's runs with the same flags
on its forced host devices (conftest gives this process 8), and against
the port's own run on one worker: weights within the JAX test's
rtol=1e-5, atol=1e-7 (tests/test_distributed.py:104-110).

This module imports no JAX package at its top: a spawned worker imports
it to find the functions it runs (`_step_worker`, `_raise_on_rank_1`).
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from lstm_rnn_tpu_torch.parallel import data as dp
from lstm_rnn_tpu_torch.parallel import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LENGTHS = [6, 5, 4, 7, 8, 3]
# a CLI run's limit: a few seconds each here; a hang fails the test
RUN_TIMEOUT = 240
RTOL, ATOL = 1e-5, 1e-7


def _write_nc(path, lengths, seed):
    from tests.test_data import _write_classification_nc
    _write_classification_nc(path, lengths, in_size=3, num_labels=4,
                             seed=seed)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The tests/test_distributed.py corpus and net, and a validation set."""
    d = tmp_path_factory.mktemp("dp_corpus")
    _write_nc(str(d / "train.nc"), LENGTHS, 7)
    _write_nc(str(d / "val.nc"), [4, 6, 2], 6)
    net = {"layers": [
        {"name": "input", "type": "input", "size": 3},
        {"name": "l1", "type": "blstm", "size": 4, "bias": 1.0},
        {"name": "output", "type": "softmax", "size": 4, "bias": 1.0},
        {"name": "postoutput", "type": "multiclass_classification",
         "size": 4}]}
    (d / "net.jsn").write_text(json.dumps(net))
    return d


def _train_args(c, *extra):
    """tests/test_distributed.py:57-66."""
    return ["--network", str(c / "net.jsn"), "--train", "true",
            "--train_file", str(c / "train.nc"), "--stochastic", "true",
            "--learning_rate", "1e-3", "--parallel_sequences", "4",
            "--random_seed", "5", "--max_epochs", "2", "--device", "cpu",
            "--fuse_fractions", "4", "--bucket_lengths", "true", *extra]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _port(args, cwd, code=None, timeout=RUN_TIMEOUT):
    """The port's CLI in a process of its own (its workers are its
    children): (returncode, stdout, stderr). On a timeout the whole
    process group is killed and the test fails."""
    cmd = [sys.executable] + (["-c", code] if code else
                              ["-m", "lstm_rnn_tpu_torch.cli"]) + list(args)
    os.makedirs(cwd, exist_ok=True)
    p = subprocess.Popen(cmd, cwd=str(cwd), env=_env(), text=True,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         start_new_session=True)
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        pytest.fail(f"the port's CLI did not end within {timeout} s: {args}")
    return p.returncode, out, err


def _port_ok(args, cwd):
    rc, out, err = _port(args, cwd)
    assert rc == 0, out[-3000:] + err[-3000:]
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _multihost(args, dirs, module="lstm_rnn_tpu_torch.cli", env=None):
    """Two CLI processes (the port's, or the JAX package's with `env`)
    joined by the multi-host flags, process i in dirs[i]: their outputs,
    each checked for rc 0."""
    port = _free_port()
    procs = []
    for i, d in enumerate(dirs):
        os.makedirs(d, exist_ok=True)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, *args,
             "--coordinator_address", f"127.0.0.1:{port}",
             "--num_processes", str(len(dirs)), "--process_id", str(i)],
            cwd=str(d), env=env or _env(), text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            start_new_session=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RUN_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def _jax_ok(args, cwd):
    """The JAX CLI in this process (conftest's 8 host devices)."""
    from lstm_rnn_tpu import cli as jax_cli
    os.makedirs(cwd, exist_ok=True)
    old = os.getcwd()
    os.chdir(cwd)
    try:
        assert jax_cli.main(list(args)) == 0
    finally:
        os.chdir(old)


def _weights(path):
    return json.loads(open(path).read())["weights"]


def _assert_weights_close(got, want):
    a, b = _weights(got), _weights(want)
    assert a.keys() == b.keys()
    for layer in b:
        for sec in b[layer]:
            np.testing.assert_allclose(a[layer][sec], b[layer][sec],
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{layer}.{sec}")


# runs shared by several tests of this module (the module runs in one
# process): key -> the directory the run wrote
_RUNS = {}


def _run_once(key, run, tmp_root):
    if key not in _RUNS:
        d = tmp_root / f"run{len(_RUNS)}"
        run(d)
        _RUNS[key] = d
    return _RUNS[key]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("dp_runs")


def _port_train(c, root, *extra):
    def run(d):
        _port_ok(_train_args(c, *extra), d)
    return _run_once(("port",) + extra, run, root) / "trained_network.jsn"


def _jax_train(c, root, *extra):
    def run(d):
        _jax_ok(_train_args(c, *extra), d)
    return _run_once(("jax",) + extra, run, root) / "trained_network.jsn"


# ---------------------------------------------------------------- arithmetic
@pytest.mark.parametrize("b, k, regression", [(4, 2, False), (3, 2, False),
                                              (5, 4, False), (3, 4, True)])
def test_pad_batch_and_local_block(b, k, regression):
    """B pads up to a multiple of k with inert rows (zero inputs,
    PATTYPE_NONE, targets -1 or 0), and the blocks are contiguous, in rank
    order, and cover the padded batch once."""
    rng = np.random.RandomState(b * 10 + k)
    T = 5
    x = rng.randn(T, b, 3).astype(np.float32)
    pt = rng.randint(1, 4, (T, b)).astype(np.int8)
    tg = (rng.randn(T, b, 2).astype(np.float32) if regression
          else rng.randint(0, 4, (T, b)).astype(np.int32))
    xp, tp, ptp = dp.pad_batch(x, tg, pt, k)
    bp = -(-b // k) * k
    assert bp % k == 0 and bp - b < k
    assert xp.shape == (T, bp, 3) and ptp.shape == (T, bp)
    assert tp.shape[:2] == (T, bp) and tp.dtype == tg.dtype
    np.testing.assert_array_equal(xp[:, :b], x)
    np.testing.assert_array_equal(tp[:, :b], tg)
    np.testing.assert_array_equal(ptp[:, :b], pt)
    assert not xp[:, b:].any() and not ptp[:, b:].any()
    assert (tp[:, b:] == (0 if regression else -1)).all()
    blocks = [dp.local_block(xp, r, k) for r in range(k)]
    assert all(blk.shape[1] == bp // k for blk in blocks)
    np.testing.assert_array_equal(np.concatenate(blocks, axis=1), xp)
    tblk = dp.local_block(torch.from_numpy(ptp), k - 1, k)
    np.testing.assert_array_equal(tblk.numpy(), ptp[:, bp - bp // k:])
    with pytest.raises(ValueError, match="multiple of the world size"):
        dp.local_block(x, 0, b + 1)


@pytest.mark.parametrize("argv, devices, hosts", [
    (["--device", "cpu", "--num_devices", "3"], 3, 1),
    (["--device", "cpu", "--num_devices", "0"], None, 1),
    (["--device", "cpu", "--num_devices", "2", "--seq_devices", "2"], None,
     1),
    (["--device", "cpu", "--num_devices", "4", "--coordinator_address",
      "10.0.0.1:1234", "--num_processes", "2", "--process_id", "1"], 1, 2),
])
def test_plan_resolves_workers(argv, devices, hosts):
    """launch.plan: k CPU workers for --num_devices k, none for one device
    or an SP run; multi-host ignores --num_devices (one CPU worker a
    process) and orders ranks process-major."""
    from lstm_rnn_tpu_torch.config import parse_config
    cfg = parse_config(["--network", "n.jsn"] + argv)
    p = launch.plan(cfg, torch.device("cpu"))
    if devices is None:
        assert p is None
        return
    assert len(p.devices) == devices and p.hosts == hosts
    assert all(d.type == "cpu" for d in p.devices)
    if hosts > 1:
        assert p.addr == ("10.0.0.1", 1234) and p.process_id == 1
        assert p.world == 2


def test_plan_counts_and_refuses_gpus(monkeypatch):
    """On CUDA: --num_devices 0 is every GPU, worker j on cuda:j; more
    than torch sees is refused with the JAX CLI's message; a multi-host
    process takes every local GPU."""
    from lstm_rnn_tpu_torch.config import parse_config
    monkeypatch.setattr("torch.cuda.device_count", lambda: 4)
    cuda = torch.device("cuda", 0)

    def plan(*argv):
        return launch.plan(parse_config(["--network", "n.jsn", *argv]), cuda)
    assert plan("--num_devices", "0").devices == tuple(
        torch.device("cuda", j) for j in range(4))
    assert plan("--num_devices", "2").world == 2
    assert plan("--num_devices", "1") is None
    p = plan("--coordinator_address", "h:1", "--num_processes", "3",
             "--process_id", "2", "--num_devices", "2")
    assert len(p.devices) == 4 and p.world == 12
    with pytest.raises(RuntimeError,
                       match="num_devices=5 but only 4 devices available"):
        plan("--num_devices", "5")
    monkeypatch.setattr("torch.cuda.device_count", lambda: 1)
    with pytest.raises(RuntimeError,
                       match="num_devices=2 but only 1 devices available"):
        plan("--num_devices", "2")


def test_rendezvous_refuses_unequal_hosts():
    """A host whose local device count differs from the others' is refused
    at the rendezvous, by process and host name, on every process."""
    addr = ("127.0.0.1", _free_port())
    errs = {}

    def host(i, n):
        p = launch.Plan((torch.device("cpu"),) * n, hosts=2, process_id=i,
                        addr=addr)
        try:
            launch._serve_store(p)
        except RuntimeError as e:
            errs[i] = str(e)
    threads = [threading.Thread(target=host, args=(i, n))
               for i, n in ((0, 2), (1, 1))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert sorted(errs) == [0, 1]
    for msg in errs.values():
        assert "same number of devices" in msg
        assert "process 0 on" in msg and "has 2" in msg
        assert "process 1 on" in msg and "has 1" in msg


@pytest.mark.parametrize("argv", [
    ["--num_devices", "2"], ["--num_devices", "0", "--device", "cpu"],
    ["--coordinator_address", "h:1", "--num_processes", "2",
     "--process_id", "0"],
    ["--train", "true", "--num_devices", "2", "--stream_chunk", "4"],
    # DP x SP and DP streaming (tests/test_torch_dp_sp.py)
    ["--num_devices", "4", "--seq_devices", "2"],
    ["--seq_devices", "2", "--coordinator_address", "h:1",
     "--num_processes", "2", "--process_id", "0"],
    ["--num_devices", "2", "--stream_chunk", "4"],
])
def test_config_lets_data_parallelism_through(argv):
    from lstm_rnn_tpu_torch.config import parse_config
    assert parse_config(["--network", "n.jsn"] + argv).network == "n.jsn"


@pytest.mark.parametrize("argv, match", [
    (["--num_devices", "3", "--seq_devices", "2"],
     "seq_devices=2 must divide num_devices=3"),
    (["--num_devices", "4", "--seq_devices", "2", "--stream_chunk", "4"],
     "stream_chunk does not combine with pipeline_devices or seq_devices"),
    (["--train", "true", "--num_devices", "3", "--model_devices", "2"],
     "model_devices=2 must divide num_devices=3"),
    (["--num_processes", "2", "--process_id", "1"],
     "need --coordinator_address"),
    (["--coordinator_address", "h:1", "--num_processes", "2",
      "--process_id", "2"], "--process_id in 0..N-1"),
])
def test_config_refuses_data_parallel_combinations(argv, match):
    """A --seq_devices that does not divide --num_devices, streaming
    with a seq mesh, and data parallelism composed with tensor parallelism
    over a count the model mesh does not divide are refused in the JAX
    CLI's words; the multi-host flags must be complete."""
    from lstm_rnn_tpu_torch.config import parse_config
    with pytest.raises(ValueError, match=match):
        parse_config(["--network", "n.jsn", "--device", "cpu"] + argv)


# ------------------------------------------------------ collectives, Trainer
def _collectives_worker(group, out_dir):
    """Two ranks: all_reduce_sum over float32 and int64 tensors, then
    gather_blocks of a rank-marked block."""
    r = group.rank
    a = torch.full((3, 2), float(r + 1))
    b = torch.arange(4, dtype=torch.float32) * (r + 1)
    c = torch.tensor(10 * (r + 1), dtype=torch.int64)
    before = dp.all_reduce_sum.collectives
    dp.all_reduce_sum([a, b, c])
    y = torch.full((5, 2, 3), float(r))
    got = dp.gather_blocks(y, group)
    torch.save({"a": a, "b": b, "c": c, "gathered": got,
                "collectives": dp.all_reduce_sum.collectives - before},
               os.path.join(out_dir, f"rank{r}.pt"))


def test_all_reduce_sum_and_gather(tmp_path):
    """all_reduce_sum sums in place with one collective per dtype;
    gather_blocks concatenates the ranks' blocks in rank order on rank 0
    only."""
    launch.start(_collectives_worker, [torch.device("cpu")] * 2,
                 (str(tmp_path),))
    res = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    for r in res:
        assert torch.equal(r["a"], torch.full((3, 2), 3.0))
        assert torch.equal(r["b"], torch.arange(4, dtype=torch.float32) * 3)
        assert r["c"].item() == 30 and r["collectives"] == 2
    assert res[1]["gathered"] is None
    g = res[0]["gathered"]
    assert g.shape == (5, 4, 3)
    assert (g[:, :2] == 0).all() and (g[:, 2:] == 1).all()


def _tiny_trainer(group=None, skip_reduce=False, **kw):
    from lstm_rnn_tpu_torch.network import Network
    from lstm_rnn_tpu_torch.trainer import Trainer
    net = Network([
        {"name": "input", "type": "input", "size": 3},
        {"name": "l1", "type": "blstm", "size": 4, "bias": 1.0},
        {"name": "output", "type": "softmax", "size": 4, "bias": 1.0},
        {"name": "postoutput", "type": "multiclass_classification",
         "size": 4}])
    net.init_params(5)
    tr = Trainer(net, None, learning_rate=1e-2, momentum=0.9,
                 hybrid_online_batch=True, device="cpu", data_group=group,
                 **kw)
    if skip_reduce:
        tr._sum_over_ranks = lambda tensors: None
    return tr


def _step_batch(b):
    """One fraction of B rows (lengths 1..7, the last row empty), host
    arrays."""
    rng = np.random.RandomState(11)
    T = 7
    lengths = rng.randint(1, T + 1, b)
    lengths[-1] = 0
    pt = (np.arange(T)[:, None] < lengths[None, :]).astype(np.int8)
    tc = rng.randint(0, 4, (T, b)).astype(np.int32)
    tc[pt == 0] = -1
    return rng.randn(T, b, 3).astype(np.float32), tc, pt


def _step_worker(group, out_dir, b, pad_targets, skip_reduce):
    """One SGD step of Trainer(data_group=) on this rank's block of the
    padded batch; saves the rank's loss and count and the parameters."""
    tr = _tiny_trainer(group, skip_reduce)
    x, tc, pt = dp.pad_batch(*_step_batch(b), group.size)
    if pad_targets:  # the control: dummy rows that carry real targets
        tc = np.where(np.arange(tc.shape[1])[None, :] >= b, 1, tc)
        pt = pt.copy()
        pt[:, b:] = 1
    blk = [torch.from_numpy(a) for a in group.block(x, tc, pt)]
    err, corr = tr.train_step(blk[0], blk[1], blk[2])
    torch.save({"err": err, "corr": corr, "params": tr.exact_params()},
               os.path.join(out_dir, f"rank{group.rank}.pt"))


@pytest.mark.parametrize("b, k", [(5, 2), (5, 4)])
def test_trainer_step_matches_one_process(tmp_path, b, k):
    """One SGD step of Trainer(data_group=) on k ranks equals the
    one-process step from the same weights: the ranks' losses and counts
    sum to its own and every rank holds its updated parameters. The
    controls must fail: a rank that leaves out the all-reduce, and padding
    rows that carry real targets."""
    tr = _tiny_trainer()
    err, corr = tr.train_step(*(torch.from_numpy(a)
                                for a in _step_batch(b)))
    want = tr.exact_params()

    def run(name, pad_targets=False, skip_reduce=False):
        d = tmp_path / name
        d.mkdir()
        launch.start(_step_worker, [torch.device("cpu")] * k,
                     (str(d), b, pad_targets, skip_reduce))
        return [torch.load(d / f"rank{r}.pt", weights_only=False)
                for r in range(k)]

    def close(params):
        return all(np.allclose(params[n][kk], want[n][kk], rtol=RTOL,
                               atol=ATOL) for n in want for kk in want[n])

    res = run("dp")
    assert abs(sum(r["err"].item() for r in res) - err.item()) <= (
        RTOL * abs(err.item()))
    assert sum(int(r["corr"]) for r in res) == int(corr)
    assert all(close(r["params"]) for r in res)
    assert not close(run("no_reduce", skip_reduce=True)[0]["params"])
    bad = run("real_pad_targets", pad_targets=True)
    assert not (close(bad[0]["params"]) and abs(sum(
        r["err"].item() for r in bad) - err.item()) <= RTOL * abs(
            err.item()))


def test_trainer_refuses_dp_with_seq_mesh():
    """DP x SP trains (tests/test_torch_dp_sp.py), but a seq mesh whose
    first device is not the data group's is refused."""
    group = dp.DataGroup(0, 2, torch.device("cpu"))
    with pytest.raises(ValueError, match="is not the data group's device"):
        _tiny_trainer(group, seq_mesh=[torch.device("cuda", 0),
                                       torch.device("cpu")])


# -------------------------------------------------------------- CLI training
@pytest.mark.parametrize("k", [2, 4])
def test_cli_training_matches_jax(corpus, root, k):
    """--num_devices k on k CPU workers against the JAX CLI's --num_devices
    k on its host devices, the same flags: the trained weights."""
    _assert_weights_close(_port_train(corpus, root, "--num_devices", str(k)),
                          _jax_train(corpus, root, "--num_devices", str(k)))


@pytest.mark.parametrize("k", [2, 4])
def test_cli_training_matches_one_worker(corpus, root, k):
    """--num_devices k against the port's run on one worker."""
    d = _port_train(corpus, root, "--num_devices", str(k)).parent
    _assert_weights_close(d / "trained_network.jsn",
                          _port_train(corpus, root))


@pytest.mark.parametrize("extra", [
    ("--stochastic", "false"),
    ("--weight_noise_sigma", "0.05"),
    ("--weight_noise_sigma", "0.05", "--stochastic", "false"),
    ("--parallel_sequences", "3"),
    ("--remat_blocks", "2"),
    ("--lstm_backend", "scan"),
], ids=["batch", "weight_noise", "weight_noise_batch", "non_dividing",
        "remat", "unfused_tail"])
def test_cli_modes_match_one_worker_and_jax(corpus, root, extra):
    """Batch mode (one all-reduce a pass), weight noise (every rank draws
    the same stream), parallel_sequences 3 on 2 workers (B padded to 4),
    --remat_blocks (checkpointed blocks and the plain tail) and the scan
    backend (the unfused tail): the port on 2 workers against its
    one-worker run and the JAX CLI's --num_devices 2."""
    got = _port_train(corpus, root, *extra, "--num_devices", "2")
    _assert_weights_close(got, _port_train(corpus, root, *extra))
    _assert_weights_close(got, _jax_train(corpus, root, *extra,
                                          "--num_devices", "2"))


@pytest.fixture(scope="module")
def multihost_train(corpus, root):
    """Two port CLI processes with the multi-host flags, each in a
    directory of its own, with a validation set, autosaves and
    --autosave_best."""
    dirs = [root / "mh0", root / "mh1"]
    outs = _multihost(_train_args(corpus, "--val_file",
                                  str(corpus / "val.nc"), "--autosave",
                                  "true", "--autosave_best", "true",
                                  "--autosave_prefix", "mh"), dirs)
    return dirs, outs


def test_multihost_training_matches_num_devices(corpus, root,
                                                multihost_train):
    """Two processes x one worker against one process with --num_devices
    2, and against the JAX CLI's run of two processes with the same flags
    (tests/test_distributed.py's launch, one host device each: the same
    global batch split)."""
    dirs, outs = multihost_train
    assert "Data-parallel mesh: {'data': 2} over 2 hosts" in outs[0]
    assert "Data-parallel mesh" not in outs[1]
    assert "Starting training" not in outs[1]
    extra = ("--val_file", str(corpus / "val.nc"), "--autosave", "true",
             "--autosave_best", "true", "--autosave_prefix", "mh")
    one = _port_train(corpus, root, *extra, "--num_devices", "2")
    _assert_weights_close(dirs[0] / "trained_network.jsn", one)
    from tests.test_distributed import _cli_env
    jax_dirs = [root / "jax_mh0", root / "jax_mh1"]
    _multihost(_train_args(corpus, *extra), jax_dirs, "lstm_rnn_tpu.cli",
               _cli_env(1))
    _assert_weights_close(dirs[0] / "trained_network.jsn",
                          jax_dirs[0] / "trained_network.jsn")


def test_only_rank_zero_writes(multihost_train):
    """Every file of the run lands in process 0's directory (rank 0's);
    process 1's workers write nothing."""
    dirs, _ = multihost_train
    assert sorted(os.listdir(dirs[1])) == []
    names = sorted(os.listdir(dirs[0]))
    assert names == ["mh.best.jsn", "mh_epoch001.autosave",
                     "mh_epoch002.autosave", "trained_network.jsn"]


def test_continue_of_dp_run_equals_straight_run(corpus, root, tmp_path):
    """A --num_devices 2 run resumed from its epoch-1 autosave ends with
    the uninterrupted --num_devices 2 run's weights (the stored
    configuration carries --num_devices)."""
    args = _train_args(corpus, "--num_devices", "2", "--max_epochs", "3",
                       "--autosave", "true", "--shuffle_fractions", "true",
                       "--weight_noise_sigma", "0.05")
    _port_ok(args, tmp_path / "straight")
    autosave = tmp_path / "straight" / "epoch001.autosave"
    out = _port_ok(["--continue", str(autosave)], tmp_path / "resumed")
    assert "Data-parallel mesh: {'data': 2}" in out
    _assert_weights_close(tmp_path / "resumed" / "trained_network.jsn",
                          tmp_path / "straight" / "trained_network.jsn")


def _raise_on_rank_1(cfg, device, group):
    """A CLI body whose rank 1 raises while rank 0 waits in a collective
    that rank 1 never joins."""
    if group.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dp.all_reduce_sum([torch.zeros(1)])
    return 0


def test_failing_worker_ends_the_run(corpus, tmp_path):
    """A worker that raises makes the CLI exit non-zero with its traceback,
    well inside the process group's timeout, and leaves no worker
    behind."""
    code = ("import sys; from lstm_rnn_tpu_torch import cli; "
            "import tests.test_torch_data_parallel as t; "
            "cli.train_mode = t._raise_on_rank_1; "
            "sys.exit(cli.main(sys.argv[1:]))")
    rc, out, err = _port(_train_args(corpus, "--num_devices", "2"),
                         tmp_path, code=code, timeout=120)
    assert rc == 2, out + err
    assert "FAILED: rank 1: RuntimeError: rank 1 fails on purpose" in out
    assert "_raise_on_rank_1" in err
    assert not os.listdir(tmp_path)


# --------------------------------------------------------------- DP serving
@pytest.fixture(scope="module")
def served(corpus, root):
    """A trained net (the port's one-worker run) and the forward flags:
    single_csv, parallel_sequences 3 (two fractions, B pads to 4)."""
    net = _port_train(corpus, root)
    return ["--network", str(net), "--train", "false", "--ff_input_file",
            str(corpus / "train.nc"), "--ff_output_format", "single_csv",
            "--parallel_sequences", "3", "--device", "cpu"]


def _assert_csv_close(a, b):
    la = open(a).read().strip().split("\n")
    lb = open(b).read().strip().split("\n")
    assert len(la) == len(lb) == len(LENGTHS)
    for x, y in zip(la, lb):
        ca, cb = x.split(";"), y.split(";")
        assert ca[0] == cb[0]
        np.testing.assert_allclose([float(v) for v in ca[1:]],
                                   [float(v) for v in cb[1:]], rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("how", ["2", "4", "multihost"])
def test_forward_matches_jax(served, tmp_path, how):
    """DP serving (--num_devices 2 and 4, and two multi-host processes)
    writes the single_csv the JAX CLI's --num_devices run writes
    (tests/test_distributed.py:167); rank 0 alone writes."""
    k = "2" if how == "multihost" else how
    out = tmp_path / "port.csv"
    if how == "multihost":
        outs = _multihost(served + ["--ff_output_file", str(out)],
                          [tmp_path / "p0", tmp_path / "p1"])
        assert "Data-parallel serving mesh: {'data': 2} over 2 hosts" \
            in outs[0]
        assert "Computing outputs" not in outs[1]
    else:
        text = _port_ok(served + ["--ff_output_file", str(out),
                                  "--num_devices", k], tmp_path / "p0")
        assert f"Data-parallel serving mesh: {{'data': {k}}}" in text
    _jax_ok(served + ["--ff_output_file", str(tmp_path / "jax.csv"),
                      "--num_devices", k], tmp_path / "j")
    _assert_csv_close(out, tmp_path / "jax.csv")
    one = tmp_path / "one.csv"
    _port_ok(served + ["--ff_output_file", str(one)], tmp_path / "p1")
    _assert_csv_close(out, one)
