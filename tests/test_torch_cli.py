"""The port's CLI (lstm_rnn_tpu_torch.cli) in forward-pass mode against the
JAX package's, on the same tiny .nc file and network.jsn: the posterior
dumps must match (single_csv and HTK), and the flags the port does not
support yet must fail loudly; in train mode, the dispatch flags against
the run without them and the JAX CLI's run with them. Data parallelism
and the multi-host flags: tests/test_torch_data_parallel.py. Train mode with the noise flags and
--init_rng currennt: tests/test_torch_noise.py, test_torch_rng_compat.py."""

import json
import os
import re

import numpy as np
import pytest

from lstm_rnn_tpu import cli as jax_cli
from lstm_rnn_tpu import writers as jax_writers
from lstm_rnn_tpu_torch import cli
from lstm_rnn_tpu_torch import writers
from tests.test_cli import _assert_csv_close
from tests.test_data import _write_classification_nc

# sequences of 6, 5, 1, 7 and 3 frames over 2 fractions of 3 rows (the
# last fraction has an all-padding row)
LENGTHS = [6, 5, 1, 7, 3]


def _setup(tmp_path):
    nc = str(tmp_path / "ff.nc")
    _write_classification_nc(nc, LENGTHS, in_size=3, num_labels=4, seed=5)
    net = {"layers": [
        {"name": "input", "type": "input", "size": 3},
        {"name": "l1", "type": "blstm", "size": 6, "bias": 1.0},
        {"name": "l2", "type": "lstm", "size": 5, "bias": 0.5},
        {"name": "output", "type": "softmax", "size": 4, "bias": 1.0},
        {"name": "postoutput", "type": "multiclass_classification",
         "size": 4},
    ]}
    net_path = str(tmp_path / "network.jsn")
    with open(net_path, "w") as f:
        json.dump(net, f)
    # no weights in the JSON: both CLIs draw them from --random_seed
    return ["--network", net_path, "--train", "false", "--ff_input_file", nc,
            "--parallel_sequences", "3", "--random_seed", "17"]


def test_forward_single_csv_matches_jax(tmp_path):
    common = _setup(tmp_path)
    assert jax_cli.main(common + ["--device", "cpu", "--ff_output_file",
                                  str(tmp_path / "jax.csv")]) == 0
    assert cli.main(common + ["--device", "cpu", "--ff_output_file",
                              str(tmp_path / "port.csv")]) == 0
    lines = (tmp_path / "port.csv").read_text().strip().split("\n")
    assert [ln.split(";")[0] for ln in lines] == [
        f"seq{i}" for i in range(len(LENGTHS))]
    for ln, n in zip(lines, LENGTHS):
        assert len(ln.split(";")) == 1 + 4 * n
    # both are true-f32 forward passes of the same weights, summed in
    # another order (the default tolerance of test_cli's serving checks)
    _assert_csv_close(tmp_path / "port.csv", tmp_path / "jax.csv")


def test_forward_htk_matches_jax(tmp_path):
    common = _setup(tmp_path) + ["--ff_output_format", "htk",
                                 "--ff_output_kind", "9",
                                 "--feature_period", "10"]
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    assert jax_cli.main(common + ["--device", "cpu", "--ff_output_file",
                                  str(tmp_path / "jax")]) == 0
    assert cli.main(common + ["--cuda", "false", "--ff_output_file",
                              str(tmp_path / "port")]) == 0
    for i, n in enumerate(LENGTHS):
        got, period, kind = writers.read_htk(str(tmp_path / "port" /
                                                 f"seq{i}.htk"))
        want, period_j, kind_j = jax_writers.read_htk(
            str(tmp_path / "jax" / f"seq{i}.htk"))
        assert got.shape == want.shape == (n, 4)
        assert (period, kind) == (period_j, kind_j) == (100000, 9)
        np.testing.assert_allclose(got.sum(-1), 1.0, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("flag", [
    # tensor and pipeline parallelism are ported (test_torch_tensor.py,
    # test_torch_pipeline.py): in forward mode --model_devices is ignored,
    # as the JAX CLI's forward mode ignores it, and --pipeline_devices
    # serves pipelined; only --device tpu is still refused
    ["--model_devices", "2"],
    ["--pipeline_devices", "2"], ["--model_devices", "2", "--num_devices", "4"],
    ["--device", "tpu"],
])
def test_unsupported_flags_raise(tmp_path, flag):
    """--device tpu raises naming ROADMAP; the parallelism flags this
    test once refused serve the posteriors of the run without them."""
    common = _setup(tmp_path) + ["--device", "cpu"]
    if flag[0] == "--device":
        with pytest.raises(ValueError, match="ROADMAP"):
            cli.main(common + flag)
        return
    for extra, out in (([], "plain.csv"), (flag, "flag.csv")):
        assert cli.main(common + extra + ["--ff_output_file",
                                          str(tmp_path / out)]) == 0
    _assert_csv_close(tmp_path / "flag.csv", tmp_path / "plain.csv",
                      rtol=1e-5, atol=1e-7)


def test_f32_matmul_3x_accepted(tmp_path):
    """--f32_matmul 3x is ported (tests/test_torch_f32_matmul_3x.py
    trains with it): the flag parses, and forward mode, which the JAX CLI
    runs without the mode (it sets it in train mode only), writes the
    bytes of the run without the flag."""
    common = _setup(tmp_path) + ["--device", "cpu"]
    outs = []
    for name, extra in (("6x", []), ("3x", ["--f32_matmul", "3x"])):
        out = tmp_path / f"{name}.csv"
        assert cli.main(common + extra + ["--ff_output_file", str(out)]) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]


def test_stream_chunk_refuses_blstm(tmp_path, capsys):
    """`--stream_chunk 4` on a net with a BLSTM layer fails with the
    ValueError naming the layer, in both CLIs, before any fraction is
    computed (a bidirectional layer cannot stream)."""
    args = _setup(tmp_path) + ["--device", "cpu", "--stream_chunk", "4",
                               "--ff_output_file", str(tmp_path / "x.csv")]
    for main in (jax_cli.main, cli.main):
        assert main(args) == 2
        out, err = capsys.readouterr()
        assert "'l1' is bidirectional" in out
        assert "ValueError" in err
        assert "Computing outputs" not in out


@pytest.mark.parametrize("flag", [
    ["--fuse_fractions", "4"], ["--device_cache", "true"],
    ["--profile_dir", "prof"], ["--compilation_cache_dir", "cache"],
])
def test_dispatch_flags_train(tmp_path, capsys, monkeypatch, flag):
    """The JAX package's dispatch flags in train mode: the trained network
    is byte for byte the run's without the flag, and within the tolerance
    of test_train_matches_jax of the JAX CLI's run with it. --device_cache
    prints the JAX CLI's cache bracket in the epoch rows, --profile_dir
    writes a Chrome trace of the first epoch, --compilation_cache_dir
    points the kernel build (ops/_build.py) at the directory, which on the
    CPU builds no kernel."""
    import jax

    from lstm_rnn_tpu import io_currennt as jax_ioc
    from lstm_rnn_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    if flag[0] != "--fuse_fractions":
        flag = [flag[0], str(tmp_path / flag[1]) if flag[1] != "true"
                else flag[1]]
    assert cli.main(_train_args(tmp_path, str(tmp_path / "plain.jsn"))) == 0
    capsys.readouterr()
    assert cli.main(_train_args(tmp_path, str(tmp_path / "port.jsn"))
                    + flag) == 0
    out = capsys.readouterr().out
    cache_dir = jax.config.jax_compilation_cache_dir
    try:
        assert jax_cli.main(_train_args(tmp_path, str(tmp_path / "jax.jsn"))
                            + flag) == 0
    finally:  # the JAX CLI sets the process's compile cache
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    out_jax = capsys.readouterr().out
    assert ((tmp_path / "port.jsn").read_bytes()
            == (tmp_path / "plain.jsn").read_bytes())
    want = jax_ioc.load_network_json(str(tmp_path / "jax.jsn"))["weights"]
    got = jax_ioc.load_network_json(str(tmp_path / "port.jsn"))["weights"]
    for name, layer in want.items():
        for part, values in layer.items():
            np.testing.assert_allclose(got[name][part], values, rtol=0,
                                       atol=1e-5, err_msg=f"{name}/{part}")
    brackets = re.findall(r"\[cache .*\]", out)
    if flag[0] == "--device_cache":
        assert brackets == re.findall(r"\[cache .*\]", out_jax)
        assert brackets == ["[cache 0/3 hit, 0 MiB]",
                            "[cache 3/3 hit, 0 MiB]"]
    else:
        assert brackets == []
    if flag[0] == "--profile_dir":
        with open(tmp_path / "prof" / "trace_rank0.json") as f:
            assert json.load(f)["traceEvents"]
        assert "Wrote the trace of epoch 1" in out
    if flag[0] == "--compilation_cache_dir":
        assert _build.BUILD_DIR == str(tmp_path / "cache")
        assert not os.path.exists(_build.library_path())


@pytest.mark.parametrize("flag", [["--model_devices", "0"],
                                  ["--pipeline_devices", "0"],
                                  ["--num_devices", "0"]])
def test_device_counts_of_one_device_run(tmp_path, flag):
    """--model_devices 0 (the TP heuristic, 1 off a TPU), --pipeline_devices
    0 (pipelines count above 1 only) and --num_devices 0 (every device: the
    CPU is one) resolve to no parallelism, as the JAX CLI resolves them on
    one device: the run equals the one without the flag."""
    common = _setup(tmp_path) + ["--device", "cpu"]
    for extra, out in (([], "plain.csv"), (flag, "flag.csv")):
        assert cli.main(common + extra + ["--ff_output_file",
                                          str(tmp_path / out)]) == 0
    assert ((tmp_path / "plain.csv").read_text()
            == (tmp_path / "flag.csv").read_text())


@pytest.mark.parametrize("flag, match", [
    (["--train", "true", "--model_devices", "2"],
     "model_devices > 1 requires num_devices > 1"),
    (["--pipeline_devices", "2", "--stream_chunk", "4"],
     "stream_chunk does not combine with pipeline_devices or seq_devices"),
])
def test_parallelism_stays_refused(tmp_path, flag, match):
    """The device counts the JAX CLI refuses for tensor and pipeline
    parallelism are refused before any work, in its words
    (lstm_rnn_tpu/cli.py:356-358, :580-586)."""
    with pytest.raises(ValueError, match=match):
        cli.main(_setup(tmp_path) + ["--device", "cpu"] + flag)


def test_num_devices_zero_counts_the_gpus(monkeypatch):
    """--num_devices 0 on the card means every GPU torch sees: data
    parallelism over the four, worker j on cuda:j, and no worker at all
    on one."""
    import torch
    from lstm_rnn_tpu_torch.config import parse_config
    from lstm_rnn_tpu_torch.parallel.launch import plan
    argv = ["--network", "n.jsn", "--num_devices", "0", "--device", "cuda"]
    cuda = torch.device("cuda", 0)
    monkeypatch.setattr("torch.cuda.device_count", lambda: 4)
    assert plan(parse_config(argv), cuda).devices == tuple(
        torch.device("cuda", j) for j in range(4))
    # a 4-block seq mesh on the four is the 1-D mesh, not DP x SP
    cfg = parse_config(argv + ["--seq_devices", "4"])
    assert cfg.num_devices == 0 and plan(cfg, cuda) is None
    monkeypatch.setattr("torch.cuda.device_count", lambda: 1)
    assert plan(parse_config(argv), cuda) is None


@pytest.mark.parametrize("flag", [["--device", "cuda"], ["--cuda", "true"]])
def test_cuda_request_without_gpu_raises(tmp_path, monkeypatch, flag):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        cli.main(_setup(tmp_path) + flag)


def _train_args(tmp_path, out):
    nc_val = str(tmp_path / "val.nc")
    _write_classification_nc(nc_val, [4, 6, 2], in_size=3, num_labels=4,
                             seed=6)
    args = _setup(tmp_path)
    args[args.index("--train") + 1] = "true"
    return args + ["--train_file", args[args.index("--ff_input_file") + 1],
                   "--val_file", nc_val, "--max_epochs", "2",
                   "--stochastic", "true", "--shuffle_fractions", "true",
                   "--truncate_seq", "4", "--learning_rate", "0.05",
                   "--momentum", "0.9", "--save_network", out,
                   "--device", "cpu"]


def test_train_matches_jax(tmp_path, capsys):
    from lstm_rnn_tpu import io_currennt as jax_ioc
    jax_out, port_out = str(tmp_path / "jax.jsn"), str(tmp_path / "port.jsn")
    assert jax_cli.main(_train_args(tmp_path, jax_out)) == 0
    assert cli.main(_train_args(tmp_path, port_out)) == 0
    out = capsys.readouterr().out
    assert "Maximum number of training epochs reached" in out
    assert "Storing the trained network" in out
    want = jax_ioc.load_network_json(jax_out)
    got = jax_ioc.load_network_json(port_out)
    assert got["layers"] == want["layers"]
    # training moved the weights away from the ones the seed drew
    from lstm_rnn_tpu_torch.network import Network
    with open(_setup(tmp_path)[1]) as f:
        start = Network(json.load(f)["layers"])
    start.init_params(17)
    trained = Network.from_json_file(port_out)
    assert not np.allclose(trained.params["l1"]["W_in"],
                           start.params["l1"]["W_in"])
    for name, layer in want["weights"].items():
        for part, values in layer.items():
            # true f32 on both sides after 2 epochs of stochastic updates
            # (test_torch_trainer holds the epoch errors)
            np.testing.assert_allclose(got["weights"][name][part], values,
                                       rtol=0, atol=1e-5,
                                       err_msg=f"{name}/{part}")
