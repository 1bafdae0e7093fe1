"""Multi-host runs resolved from the environment (lstm_rnn_tpu_torch/
parallel/cluster.py), as the JAX CLI resolves them through
lstm_rnn_tpu/parallel/distributed.py `maybe_initialize` and
`jax.distributed.initialize`: JAX_COORDINATOR_ADDRESS for the coordinator,
Open MPI's or SLURM's variables for the count, the rank and the local
rank, an explicit flag always first.

Two port CLI processes started with the environment alone (no multi-host
flag) are held against the JAX CLI's two processes under the same
environment, at the size of tests/test_torch_data_parallel.py (weights
within its rtol=1e-5, atol=1e-7); the rest are checks of the resolution
and of the plan it gives."""

import os
import signal
import subprocess
import sys

import pytest
import torch

from lstm_rnn_tpu_torch.parallel import cluster, launch
from tests.test_torch_data_parallel import (LENGTHS, RUN_TIMEOUT,
                                            _assert_weights_close, _env,
                                            _free_port, _train_args,
                                            _write_nc)

# every variable a cluster probe reads: cleared before each case
CLUSTER_VARS = ["JAX_COORDINATOR_ADDRESS", "JAX_LOCAL_DEVICE_IDS"] + sorted(
    {v for present, *names in cluster.CLUSTERS for v in (*present, *names)})


def _cluster_env(kind, rank, size=2, local=None):
    """The variables mpirun or srun gives process `rank` of `size`, all on
    one node (local rank = rank unless given)."""
    local = rank if local is None else local
    if kind == "ompi":
        return {"OMPI_MCA_orte_hnp_uri": "1531576320.0;tcp://127.0.0.1:34911",
                "OMPI_COMM_WORLD_SIZE": str(size),
                "OMPI_COMM_WORLD_RANK": str(rank),
                "OMPI_COMM_WORLD_LOCAL_RANK": str(local)}
    return {"SLURM_JOB_ID": "4242", "SLURM_STEP_NODELIST": "localhost",
            "SLURM_NTASKS": str(size), "SLURM_PROCID": str(rank),
            "SLURM_LOCALID": str(local)}


@pytest.fixture
def clean_env(monkeypatch):
    for v in CLUSTER_VARS:
        monkeypatch.delenv(v, raising=False)
    return monkeypatch


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    import json
    d = tmp_path_factory.mktemp("env_corpus")
    _write_nc(str(d / "train.nc"), LENGTHS, 7)
    net = {"layers": [
        {"name": "input", "type": "input", "size": 3},
        {"name": "l1", "type": "blstm", "size": 4, "bias": 1.0},
        {"name": "output", "type": "softmax", "size": 4, "bias": 1.0},
        {"name": "postoutput", "type": "multiclass_classification",
         "size": 4}]}
    (d / "net.jsn").write_text(json.dumps(net))
    return d


def _from_env(args, dirs, kind, module, base):
    """Two CLI processes of `module` started with JAX_COORDINATOR_ADDRESS
    and the cluster's variables and no multi-host flag, process i in
    dirs[i]: their outputs, each checked for rc 0."""
    port = _free_port()
    procs = []
    for i, d in enumerate(dirs):
        os.makedirs(d, exist_ok=True)
        env = {k: v for k, v in base.items() if k not in CLUSTER_VARS}
        env.update(_cluster_env(kind, i),
                   JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, *args], cwd=str(d), env=env,
            text=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
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


@pytest.mark.parametrize("kind", ["ompi", "slurm"])
def test_cli_from_the_environment_matches_jax(corpus, tmp_path, kind):
    """Two port CLI processes started by Open MPI's or SLURM's variables
    and JAX_COORDINATOR_ADDRESS, with no multi-host flag, train one
    data-parallel run over two processes (process 0 prints the JAX CLI's
    banner, process 1 nothing) whose weights are the JAX CLI's two
    processes' under the same environment."""
    from tests.test_distributed import _cli_env
    args = _train_args(corpus)
    outs = _from_env(args, [tmp_path / "p0", tmp_path / "p1"], kind,
                     "lstm_rnn_tpu_torch.cli", _env())
    assert "Data-parallel mesh: {'data': 2} over 2 hosts" in outs[0]
    assert "Starting training" not in outs[1]
    _from_env(args, [tmp_path / "j0", tmp_path / "j1"], kind,
              "lstm_rnn_tpu.cli", _cli_env(1))
    _assert_weights_close(tmp_path / "p0" / "trained_network.jsn",
                          tmp_path / "j0" / "trained_network.jsn")


def test_explicit_flags_win_over_the_environment(clean_env):
    """--coordinator_address, --num_processes and --process_id each win
    over what the environment says; what they leave open comes from it
    (the local rank too), Open MPI's before SLURM's."""
    from lstm_rnn_tpu_torch.config import parse_config
    for k, v in {**_cluster_env("slurm", 1, local=3),
                 "JAX_COORDINATOR_ADDRESS": "10.0.0.9:99"}.items():
        clean_env.setenv(k, v)

    def resolved(*argv):
        cfg = parse_config(["--network", "n.jsn", *argv])
        return (cfg.coordinator_address, cfg.num_processes, cfg.process_id,
                cfg.local_device_ids)

    assert resolved() == ("10.0.0.9:99", 2, 1, (3,))
    assert resolved("--coordinator_address", "h:1", "--num_processes", "4",
                    "--process_id", "3") == ("h:1", 4, 3, (3,))
    assert resolved("--process_id", "0") == ("10.0.0.9:99", 2, 0, (3,))
    for k, v in _cluster_env("ompi", 2, size=5, local=0).items():
        clean_env.setenv(k, v)
    assert resolved() == ("10.0.0.9:99", 5, 2, (0,))
    clean_env.setenv("JAX_LOCAL_DEVICE_IDS", "1,2")
    assert resolved("--num_processes", "6") == ("10.0.0.9:99", 6, 2, (1, 2))
    # the autosave's configuration keeps no process identity
    cfg = parse_config(["--network", "n.jsn"])
    assert "local_device_ids" not in cfg.serialized_options
    assert "process_id" not in cfg.serialized_options


@pytest.mark.parametrize("how", ["env", "flag"])
def test_coordinator_without_a_count_is_refused(clean_env, how):
    """A coordinator (the flag or JAX_COORDINATOR_ADDRESS) with no count
    from the flags or any cluster is refused in jax's words; with a count
    and no rank, the rank is named; with no coordinator at all the
    cluster's variables start no multi-host run."""
    from lstm_rnn_tpu_torch.config import parse_config
    argv = ["--network", "n.jsn"]
    if how == "env":
        clean_env.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
        name = "JAX_COORDINATOR_ADDRESS"
    else:
        argv += ["--coordinator_address", "127.0.0.1:1"]
        name = "--coordinator_address"
    with pytest.raises(ValueError, match="Number of processes must be "
                                         f"defined: {name} is set"):
        parse_config(argv)
    with pytest.raises(ValueError, match="The process id of the current "
                                         "process must be defined"):
        parse_config(argv + ["--num_processes", "2"])
    clean_env.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    for k, v in _cluster_env("slurm", 1).items():
        clean_env.setenv(k, v)
    cfg = parse_config(["--network", "n.jsn", "--device", "cpu"])
    assert (cfg.coordinator_address, cfg.local_device_ids) == ("", None)
    assert launch.plan(cfg, torch.device("cpu")) is None


@pytest.mark.parametrize("kind", ["ompi", "slurm"])
def test_local_rank_binds_the_plan_to_its_gpu(clean_env, kind):
    """On a host of 4 GPUs (a faked device count, as
    test_plan_counts_and_refuses_gpus fakes it) the cluster's local rank
    gives the plan one worker on cuda:{local rank}, rank = process id;
    explicit flags with no local rank keep every local GPU, a worker each;
    a local rank past the host's GPUs is refused."""
    from lstm_rnn_tpu_torch.config import parse_config
    clean_env.setattr("torch.cuda.device_count", lambda: 4)
    cuda = torch.device("cuda", 0)
    for k, v in _cluster_env(kind, 5, size=8, local=2).items():
        clean_env.setenv(k, v)
    clean_env.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.1:1234")
    p = launch.plan(parse_config(["--network", "n.jsn"]), cuda)
    assert p.devices == (torch.device("cuda", 2),)
    assert (p.hosts, p.process_id, p.world) == (8, 5, 8)
    assert p.addr == ("10.0.0.1", 1234)
    for k in CLUSTER_VARS:
        clean_env.delenv(k, raising=False)
    p = launch.plan(parse_config(["--network", "n.jsn",
                                  "--coordinator_address", "h:1",
                                  "--num_processes", "2",
                                  "--process_id", "1"]), cuda)
    assert p.devices == tuple(torch.device("cuda", j) for j in range(4))
    clean_env.setenv("JAX_COORDINATOR_ADDRESS", "h:1")
    for k, v in _cluster_env(kind, 1, local=4).items():
        clean_env.setenv(k, v)
    with pytest.raises(RuntimeError, match=r"local device ids \[4\] but "
                                           "only 4 devices available"):
        launch.plan(parse_config(["--network", "n.jsn"]), cuda)
