"""The recipes and scripts on the port, on the CPU: the data generator
(examples/make_example_data_torch.py) against the JAX package's, every
examples/*/run_torch.sh trained one epoch on a tiny generated corpus (two
of them against their run.sh on the JAX CLI), the generator's
never-clobber rule, and the scripts on the port's own outputs:
scripts/torch_discriminative_pretraining.py, average_weights.py,
add_layer.py, act_maj_vote.py and the TIMIT recipe's test_post_conv.py."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from lstm_rnn_tpu_torch.network import Network
from lstm_rnn_tpu_torch.writers import read_htk
from tests.test_data import _write_classification_nc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
RECIPES = ["lvcsr_physical_states", "phoneme_recognition_timit",
           "speech_autoencoding_chime",
           "speech_recognition_chime/no_subsampling",
           "speech_recognition_chime/subsampling"]
# 1-epoch overrides on the CPU, as tests/test_examples_and_modes.py runs
# run.sh (CLI flags beat the options file), and a weight seed (the
# recipes' networks carry no weights, and seed 0 draws from the clock)
OVERRIDES = ["--max_epochs", "1", "--parallel_sequences", "2", "--device",
             "cpu", "--input_noise_sigma", "0", "--random_seed", "11"]
GEN_ARGS = ["--seqs", "6", "--len-scale", "0.1"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run(cmd, cwd=None):
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=cwd,
                       env=_env())
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


def _generator(path):
    spec = importlib.util.spec_from_file_location(
        os.path.basename(path)[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def _nc_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs
                  if f.endswith(".nc"))


def test_generator_writes_the_jax_generators_bytes(tmp_path):
    """make_example_data_torch.py writes every recipe's corpora with the
    bytes make_example_data.py writes for the same arguments."""
    for name in ("make_example_data.py", "make_example_data_torch.py"):
        out = tmp_path / name
        for d in ("speech_recognition_chime", "speech_autoencoding_chime"):
            (out / d).mkdir(parents=True)
        assert _generator(os.path.join(EXAMPLES, name))(
            GEN_ARGS + ["--out-root", str(out)]) == 0
    files = _nc_files(tmp_path / "make_example_data.py")
    assert len(files) == 8
    assert files == _nc_files(tmp_path / "make_example_data_torch.py")
    for f in files:
        assert ((tmp_path / "make_example_data_torch.py" / f).read_bytes()
                == (tmp_path / "make_example_data.py" / f).read_bytes()), f


def test_generator_never_clobbers_existing(tmp_path):
    """An existing file of a pair (possibly real data) survives untouched
    and only the missing one is generated, as make_example_data.py's
    rule (tests/test_examples_and_modes.py:113)."""
    out = tmp_path / "speech_recognition_chime"
    out.mkdir()
    real = out / "train_1_speaker.nc"
    real.write_bytes(b"REAL DATA, DO NOT TOUCH")
    stdout = _run([sys.executable,
                   os.path.join(EXAMPLES, "make_example_data_torch.py"),
                   "chime_recognition", "--seqs", "2", "--len-scale", "0.05",
                   "--out-root", str(tmp_path)])
    assert real.read_bytes() == b"REAL DATA, DO NOT TOUCH"
    assert "left untouched" in stdout
    assert (out / "val_1_speaker.nc").exists()


@pytest.fixture(scope="module")
def examples_tree(tmp_path_factory):
    """A copy of examples/ with a tiny corpus for every recipe, from the
    port's generator."""
    ex = tmp_path_factory.mktemp("recipes") / "examples"
    shutil.copytree(EXAMPLES, ex)
    _run([sys.executable, str(ex / "make_example_data_torch.py"), *GEN_ARGS,
          "--overwrite"])
    return ex


def _weights(path):
    with open(path) as f:
        return json.load(f)["weights"]


@pytest.mark.parametrize("recipe", RECIPES)
def test_run_torch_trains_the_recipe(examples_tree, recipe):
    """run_torch.sh trains its recipe's config.cfg one epoch on the port's
    CLI and stores trained_network.jsn; for CHiME recognition and LVCSR the
    weights lie within test_torch_cli.py's train tolerance (1e-5) of
    run.sh's on the JAX CLI, in a second copy of the recipe's directory
    over the same corpus."""
    d = examples_tree / recipe
    sh = (d / "run_torch.sh").read_text()
    assert "lstm_rnn_tpu_torch.cli" in sh and "lstm_rnn_tpu.cli" not in sh
    out = _run(["sh", "run_torch.sh", *OVERRIDES], cwd=str(d))
    assert "Storing the trained network" in out
    port = d / "trained_network.jsn"
    assert port.exists()
    net = Network.from_json_file(str(port))
    assert net.params
    if recipe not in ("lvcsr_physical_states",
                      "speech_recognition_chime/no_subsampling"):
        return
    jax_dir = d.parent / (d.name + "_jax")
    shutil.copytree(d, jax_dir)
    (jax_dir / "trained_network.jsn").unlink()
    _run(["sh", "run.sh", *OVERRIDES], cwd=str(jax_dir))
    want = _weights(jax_dir / "trained_network.jsn")
    got = _weights(port)
    assert sorted(got) == sorted(want)
    for name, layer in want.items():
        for part, values in layer.items():
            np.testing.assert_allclose(got[name][part], values, rtol=0,
                                       atol=1e-5, err_msg=f"{name}/{part}")


def _toy_net(path):
    net = {"layers": [
        {"name": "input", "type": "input", "size": 3},
        {"name": "h1", "type": "lstm", "size": 4, "bias": 1.0},
        {"name": "h2", "type": "blstm", "size": 4, "bias": 1.0},
        {"name": "output", "type": "softmax", "size": 4, "bias": 1.0},
        {"name": "postoutput", "type": "multiclass_classification",
         "size": 4},
    ]}
    path.write_text(json.dumps(net))


def test_scripts_on_the_ports_outputs(tmp_path):
    """The scripts on what the port writes: greedy pretraining through the
    port's CLI (stage files, stage 2 seeded from stage 1), two of its
    networks averaged (the mean, loaded by the port's Network), a layer
    added (loaded by the port's Network, which serves it), the majority
    vote over the port's single_csv posteriors, and test_post_conv.py on
    its HTK posteriors."""
    nc = str(tmp_path / "train.nc")
    _write_classification_nc(nc, [6, 5, 4, 7], in_size=3, num_labels=4,
                             seed=9)
    _toy_net(tmp_path / "full.jsn")
    cfg = tmp_path / "pre.cfg"
    cfg.write_text("train = true\nstochastic = true\nparallel_sequences = 2"
                   "\nrandom_seed = 5\ndevice = cpu\n")
    work = tmp_path / "work"
    _run([sys.executable,
          os.path.join(REPO, "scripts/torch_discriminative_pretraining.py"),
          str(tmp_path / "full.jsn"), str(cfg), str(work), nc, "-", "-", "2",
          "1e-3", "0.5"], cwd=str(tmp_path))
    s1, s2 = _weights(work / "trained.1.jsn"), _weights(work / "trained.2.jsn")
    assert "lstm_rnn_tpu_torch.cli" in (work / "pretrain.1.log").read_text()
    w1 = np.asarray(s1["hidden_layer_1"]["input"])
    w2 = np.asarray(s2["hidden_layer_1"]["input"])
    assert not np.array_equal(w1, w2)
    np.testing.assert_allclose(w1, w2, atol=5e-2)
    assert "hidden_layer_2" in s2

    def script(name, *args, cwd=None):
        return _run([sys.executable, os.path.join(REPO, name), *args],
                    cwd=cwd)

    # two networks of one topology: stage 2 and one more epoch of it
    again = tmp_path / "again.jsn"
    _run([sys.executable, "-m", "lstm_rnn_tpu_torch.cli", "--network",
          str(work / "trained.2.jsn"), "--train", "true", "--train_file",
          nc, "--max_epochs", "1", "--parallel_sequences", "2",
          "--learning_rate", "0.05", "--save_network", str(again),
          "--autosave", "false", "--device", "cpu"], cwd=str(tmp_path))
    avg = tmp_path / "avg.jsn"
    script("scripts/average_weights.py", str(work / "trained.2.jsn"),
           str(again), str(avg))
    a, b, m = s2, _weights(again), _weights(avg)
    for name in a:
        for part in a[name]:
            np.testing.assert_allclose(
                m[name][part], (np.asarray(a[name][part])
                                + np.asarray(b[name][part])) / 2,
                rtol=1e-6, atol=1e-7)
    Network.from_json_file(str(avg))

    grown = tmp_path / "grown.jsn"
    script("scripts/add_layer.py", str(avg), str(grown), "hidden_layer_3",
           "lstm", "5")
    net = Network.from_json_file(str(grown))
    assert [s.name for s in net.specs][-3:] == [
        "hidden_layer_3", "output", "postoutput"]

    # the grown net serves; single_csv for the vote, HTK for post_conv
    csv = tmp_path / "post.csv"
    serve = [sys.executable, "-m", "lstm_rnn_tpu_torch.cli", "--network",
             str(grown), "--train", "false", "--ff_input_file", nc,
             "--parallel_sequences", "2", "--device", "cpu",
             "--random_seed", "3"]
    _run(serve + ["--ff_output_file", str(csv)], cwd=str(tmp_path))
    votes = script("scripts/act_maj_vote.py", str(csv), "4").split("\n")
    want = []
    for line in csv.read_text().strip().split("\n"):
        tag, *vals = line.split(";")
        post = np.asarray(vals, np.float64).reshape(-1, 4)
        want.append(f"{tag} {int(post.sum(0).argmax())}")
    assert [v for v in votes if v] == want

    htk_dir = tmp_path / "htk"
    htk_dir.mkdir()
    _run(serve + ["--ff_output_format", "htk", "--ff_output_file",
                  str(htk_dir)], cwd=str(tmp_path))
    names = sorted(os.listdir(htk_dir))
    assert names
    (tmp_path / "test.scp").write_text(
        "".join(f"htk/{n}\n" for n in names))
    (tmp_path / "state.map").write_text("3:0\n0:1\n1:2\n2:3\n")
    script("examples/phoneme_recognition_timit/test_post_conv.py",
           "test.scp", "state.map", "conv", cwd=str(tmp_path))
    for n in names:
        src, _, _ = read_htk(str(htk_dir / n))
        out, _, _ = read_htk(str(tmp_path / "conv" / "htk" / n))
        np.testing.assert_array_equal(out, src[:, [3, 0, 1, 2]])
