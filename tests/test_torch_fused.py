"""The port's fused passes (`fuse_fractions`, lstm_rnn_tpu_torch/
trainer.py): the cases of tests/test_fused.py about fused groups and the
stacked epoch. Each runs the port with fuse K against the port with fuse
1, bit for bit (on the CPU the fused passes run the same steps eagerly,
in the same order), and against the JAX Trainer with the same K, fed the
same numpy weights, within the JAX file's own tolerance (rel 1e-6, atol
1e-8), with the same cache lookups and the same "Epoch-resident fast
path declined" lines. The step graphs themselves run on the card:
tests/test_torch_kernels_cuda.py."""

import re

import numpy as np
import pytest
import torch

from lstm_rnn_tpu.data.dataset import DataSet as JaxDataSet
from lstm_rnn_tpu.network import Network as JaxNetwork
from lstm_rnn_tpu.trainer import Trainer as JaxTrainer
from lstm_rnn_tpu_torch.data.dataset import DataSet
from lstm_rnn_tpu_torch.network import Network
from lstm_rnn_tpu_torch.parallel.mesh import make_seq_mesh
from lstm_rnn_tpu_torch.trainer import Trainer
from tests.test_data import _write_classification_nc

LAYERS = [
    {"name": "input", "type": "input", "size": 3},
    {"name": "l1", "type": "blstm", "size": 4, "bias": 1.0},
    {"name": "output", "type": "softmax", "size": 4, "bias": 1.0},
    {"name": "postoutput", "type": "multiclass_classification", "size": 4},
]
# 12 sequences of 8 frames: 4 fractions of 3, one shape
ONE_SHAPE = [8] * 12
# two length buckets (16 and 24) with a short last fraction: 11
# sequences, 4 fractions of 3, the last with 2
TWO_BUCKETS = [8] * 5 + [20] * 6
# the JAX file's tolerance (tests/test_fused.py)
RTOL, ATOL = 1e-6, 1e-8
DECLINED = "Epoch-resident fast path declined"


def _trainer(tmp_path, pkg, lengths=ONE_SHAPE, val=False, epochs=3,
             ds_kw=None, remat_blocks=0, **kw):
    tr = str(tmp_path / "tr.nc")
    _write_classification_nc(tr, lengths, in_size=3, num_labels=4, seed=2)
    ds_kw = {"parallel_sequences": 3, "sort_by_length": True,
             "prefetch": False, "fraction_shuffling": True, "seed": 11,
             **(ds_kw or {})}
    va = None
    if val:
        va = str(tmp_path / "va.nc")
        _write_classification_nc(va, [5, 9, 7, 14, 3, 6], in_size=3,
                                 num_labels=4, seed=9)
    if pkg == "jax":
        DS, Net, Tr, extra = JaxDataSet, JaxNetwork, JaxTrainer, {}
    else:
        DS, Net, Tr, extra = DataSet, Network, Trainer, {"device": "cpu"}
    net = Net(LAYERS)
    # one draw of numpy weights for both packages (params_from_numpy)
    ref = Network(LAYERS)
    ref.init_params(5)
    net.params = {n: {k: np.array(v) for k, v in layer.items()}
                  for n, layer in ref.params.items()}
    net.remat_blocks = remat_blocks
    kw = {"hybrid_online_batch": True, **kw}
    t = Tr(net, DS([tr], **ds_kw), DS([va], **ds_kw) if val else None,
           learning_rate=1e-3, momentum=0.9, max_epochs=epochs, **extra,
           **kw)
    if pkg == "jax":
        # its whole-epoch compile on the calling thread, as
        # tests/test_fused.py does, so that every pass runs stacked
        t._spawn_warm_compile = lambda stacks, update: None
    return t


def _train(t, stats=None):
    rows = []
    done = False
    while not done:
        done = t.train_epoch()
        rows.append((t.cur_training_error, t.cur_training_class_error,
                     t.cur_validation_error, t.cur_validation_class_error))
        if stats is not None:
            stats.append(t.device_cache_stats())
    params = {n: {k: np.asarray(v) for k, v in layer.items()}
              for n, layer in t.exact_params().items()}
    return rows, params


def _assert_bitwise(a, b):
    assert a[0] == b[0]
    for n in b[1]:
        for k in b[1][n]:
            np.testing.assert_array_equal(a[1][n][k], b[1][n][k],
                                          err_msg=f"{n}/{k}")


def _assert_close_to_jax(port, jax):
    for got, want in zip(port[0], jax[0]):
        assert got == pytest.approx(want, rel=RTOL)
        assert got[1] == want[1] and got[3] == want[3]  # class errors
    for n in jax[1]:
        for k in jax[1][n]:
            np.testing.assert_allclose(port[1][n][k], jax[1][n][k],
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{n}/{k}")


def _declines(text):
    return [ln for ln in text.splitlines() if ln.startswith(DECLINED)]


@pytest.mark.parametrize("fuse", [2, 4])
def test_fused_equals_unfused(tmp_path, fuse):
    """Bucketed fractions in shuffled order, with validation (fused
    evaluation passes), no cache: the grouped route equals the unfused
    run bit for bit, and the JAX Trainer's grouped run within its
    tolerance."""
    kw = {"lengths": TWO_BUCKETS + [12] * 6, "val": True,
          "ds_kw": {"bucket_lengths": True}}
    want = _train(_trainer(tmp_path, "port", **kw))
    t = _trainer(tmp_path, "port", fuse_fractions=fuse, **kw)
    got = _train(t)
    _assert_bitwise(got, want)
    assert t._stacked == {}
    _assert_close_to_jax(got, _train(_trainer(tmp_path, "jax",
                                              fuse_fractions=fuse, **kw)))


def test_device_cache_fused_and_noise_gate(tmp_path):
    """The cache and fuse 2 compose (a 2-fraction fuse count declines the
    stacked epoch): the plain run's values, the JAX Trainer's lookups;
    input-noise fractions are never cached and still group."""
    kw = {"lengths": TWO_BUCKETS, "ds_kw": {"bucket_lengths": True},
          "epochs": 2}
    want = _train(_trainer(tmp_path, "port", **kw))
    t = _trainer(tmp_path, "port", device_cache=True, fuse_fractions=2, **kw)
    stats = []
    got = _train(t, stats)
    _assert_bitwise(got, want)
    assert len(t._dev_cache) > 0 and t._stacked == {}
    j = _trainer(tmp_path, "jax", device_cache=True, fuse_fractions=2, **kw)
    jstats = []
    _assert_close_to_jax(got, _train(j, jstats))
    keys = ("hits", "misses", "entries")
    assert [[s[k] for k in keys] for s in stats] == [
        [s[k] for k in keys] for s in jstats] == [[0, 4, 4], [4, 0, 4]]

    noisy = dict(kw, ds_kw={"bucket_lengths": True, "noise_deviation": 0.1})
    want = _train(_trainer(tmp_path, "port", **noisy))
    t = _trainer(tmp_path, "port", device_cache=True, fuse_fractions=2,
                 **noisy)
    _assert_bitwise(_train(t), want)
    assert len(t._dev_cache) == 0 and t._stacked == {}


def _stacked_case(tmp_path, lengths, ds_kw=None, val=False):
    kw = {"lengths": lengths, "ds_kw": ds_kw, "val": val}
    want = _train(_trainer(tmp_path, "port", **kw))
    t = _trainer(tmp_path, "port", fuse_fractions=8, device_cache=True, **kw)
    stats = []
    got = _train(t, stats)
    _assert_bitwise(got, want)
    j = _trainer(tmp_path, "jax", fuse_fractions=8, device_cache=True, **kw)
    jstats = []
    _assert_close_to_jax(got, _train(j, jstats))
    keys = ("hits", "misses", "entries")
    assert [[s[k] for k in keys] for s in stats] == [
        [s[k] for k in keys] for s in jstats]
    return t, j, stats


def test_stacked_epoch_with_shuffled_perm_matches_unfused(tmp_path):
    """One shape, fuse >= the fraction count, the cache on: the pass runs
    as the stacked epoch, stepping each epoch's shuffled order from the
    pass's entry; the last epoch's lookups all hit it and the fractions'
    own cache entries are gone."""
    t, j, stats = _stacked_case(tmp_path, ONE_SHAPE)
    assert len(t._stacked) == len(j._stacked) == 1
    assert (stats[-1]["hits"], stats[-1]["misses"]) == (4, 0)
    assert stats[0]["misses"] == 4 and stats[-1]["entries"] == 0
    assert t._dev_cache == {}


def test_stacked_epoch_multi_bucket_matches_unfused(tmp_path):
    """Two buckets and a short last fraction, with validation: one
    resident entry for the training set (its fractions of both buckets)
    and one for the validation set, each pass's last lookups all hits."""
    t, j, stats = _stacked_case(tmp_path, TWO_BUCKETS,
                                ds_kw={"bucket_lengths": True}, val=True)
    assert len(t._stacked) == len(j._stacked) == 2
    train = t._stacked[t.train_set.fraction_meta(0)[0][0]]
    assert sorted({tuple(b[0].shape) for b in train["rows"].values()}) == [
        (16, 3, 3), (24, 3, 3)]
    assert (stats[-1]["hits"], stats[-1]["misses"]) == (4 + 2, 0)
    assert t._dev_cache == {}


def test_stacked_epoch_builds_on_host(tmp_path, monkeypatch):
    """Each fraction of a stacked pass is assembled on the host and
    reaches the device in one host-to-device copy (inputs, targets and
    pattypes in one staging buffer), in the first pass only, which its
    copied bytes count; later passes copy nothing, and the entry's bytes
    are the cache's."""
    puts = []
    orig = Trainer._to_device
    monkeypatch.setattr(Trainer, "_to_device",
                        lambda self, h: puts.append(h[0].shape)
                        or orig(self, h))
    t = _trainer(tmp_path, "port", fuse_fractions=8, device_cache=True,
                 epochs=2)
    _train(t)
    assert puts == [(8, 3, 3)] * 4
    assert t.h2d_bytes == [4 * 8 * 3 * (3 * 4 + 4 + 1), 0]
    entry = next(iter(t._stacked.values()))
    assert t._dev_cache_bytes == entry["bytes"] == t.h2d_bytes[0]


def test_stacked_epoch_drops_a_changed_corpus(tmp_path):
    """A pass whose fractions the stack does not hold (the corpus'
    membership changed) drops the stack and builds it again."""
    t = _trainer(tmp_path, "port", fuse_fractions=8, device_cache=True)
    t.train_epoch()
    token = next(iter(t._stacked))
    entry = t._stacked[token]
    entry["rows"] = {("gone",) + k[1:]: b for k, b in entry["rows"].items()}
    before = t._dev_cache_bytes
    t.train_epoch()
    assert t._stacked[token] is not entry
    assert t._dev_cache_bytes == before
    assert t.device_cache_stats()["misses"] == 4


def test_stacked_decline_reason_is_printed_once(tmp_path, capsys):
    """A declined stacked epoch names its gate once a reason, in the JAX
    Trainer's words: a fuse count below the fraction count, a budget too
    small (the GiB numbers), more shapes than STACKED_MAX_SHAPES; the
    passes then run grouped with the plain run's values."""
    lines = {}
    for label, kw in (("fuse", {"fuse_fractions": 2}),
                      ("budget", {"fuse_fractions": 8,
                                  "device_cache_bytes": 16}),
                      ("shapes", {"fuse_fractions": 64,
                                  "lengths": list(range(1, 28)),
                                  "ds_kw": {"fraction_shuffling": False}})):
        for pkg in ("port", "jax"):
            t = _trainer(tmp_path, pkg, device_cache=True, epochs=2, **kw)
            res = _train(t)
            lines[label, pkg] = _declines(capsys.readouterr().out)
            if pkg == "port":
                plain = {k: v for k, v in kw.items()
                         if k in ("lengths", "ds_kw")}
                _assert_bitwise(res, _train(_trainer(tmp_path, "port",
                                                     epochs=2, **plain)))
        assert lines[label, "port"] == lines[label, "jax"]
        assert len(lines[label, "port"]) == 1
    assert "fuse_fractions=2 < 4 fractions" in lines["fuse", "port"][0]
    assert re.search(r"needs ~0\.00 GiB but only 0\.00 GiB of "
                     r"device_cache_bytes", lines["budget", "port"][0])
    assert "distinct fraction shapes > 8" in lines["shapes", "port"][0]


def test_passes_outside_the_fuse_gate_step_one_at_a_time(tmp_path, capsys):
    """Batch mode and weight noise keep stepping one fraction at a time
    (no stack, no decline line); the validation pass still fuses. A model
    mesh (tensor parallelism: the CPU twice) takes the fused passes: the
    stacked epoch, with validation, no note, bit for bit its unfused run
    and within the JAX file's tolerance of the JAX Trainer's fused run on
    its 2-device model mesh, with its cache lookups and decline lines. (A
    seq or pipe mesh in one process: test_seq_and_pipe_meshes_fuse.)"""
    from lstm_rnn_tpu.parallel.mesh import make_mesh_2d
    for kw in ({"hybrid_online_batch": False},
               {"weight_noise_sigma": 0.05}):
        want = _train(_trainer(tmp_path, "port", val=True, **kw))
        t = _trainer(tmp_path, "port", val=True, fuse_fractions=8,
                     device_cache=True, **kw)
        _assert_bitwise(_train(t), want)
        assert len(t._stacked) == 1  # the validation set's
        assert DECLINED not in capsys.readouterr().out
    kw = {"lengths": TWO_BUCKETS, "ds_kw": {"bucket_lengths": True},
          "val": True, "epochs": 2}
    mesh = make_seq_mesh(2, "cpu")
    want = _train(_trainer(tmp_path, "port", model_mesh=mesh, **kw))
    capsys.readouterr()
    t = _trainer(tmp_path, "port", model_mesh=mesh, fuse_fractions=8,
                 device_cache=True, **kw)
    stats = []
    got = _train(t, stats)
    out = capsys.readouterr().out
    _assert_bitwise(got, want)
    assert len(t._stacked) == 2 and "one fraction at a time" not in out
    j = _trainer(tmp_path, "jax", fuse_fractions=8, device_cache=True,
                 mesh=make_mesh_2d(2, 2), **kw)
    jstats = []
    _assert_close_to_jax(got, _train(j, jstats))
    assert _declines(out) == _declines(capsys.readouterr().out) == []
    keys = ("hits", "misses", "entries")
    assert [[s[k] for k in keys] for s in stats] == [
        [s[k] for k in keys] for s in jstats]


@pytest.mark.parametrize("axis", ["seq", "pipe"])
def test_seq_and_pipe_meshes_fuse(tmp_path, capsys, axis):
    """A one-process seq or pipe mesh of 2 (the CPU twice) takes the
    fused passes: the stacked epoch, with validation, bit for bit the
    unfused run on the same mesh and within the JAX file's tolerance of
    the JAX Trainer's fused run on its 2-device mesh, with its cache
    lookups and decline lines; no note."""
    from lstm_rnn_tpu.parallel.mesh import make_mesh
    kw = {"lengths": TWO_BUCKETS, "ds_kw": {"bucket_lengths": True},
          "val": True, "epochs": 2}
    mesh = {f"{axis}_mesh": make_seq_mesh(2, "cpu")}
    want = _train(_trainer(tmp_path, "port", **mesh, **kw))
    capsys.readouterr()
    t = _trainer(tmp_path, "port", fuse_fractions=8, device_cache=True,
                 **mesh, **kw)
    stats = []
    got = _train(t, stats)
    out = capsys.readouterr().out
    _assert_bitwise(got, want)
    assert len(t._stacked) == 2 and "one fraction at a time" not in out
    j = _trainer(tmp_path, "jax", fuse_fractions=8, device_cache=True,
                 **{f"{axis}_mesh": make_mesh(2, axis=axis)}, **kw)
    jstats = []
    _assert_close_to_jax(got, _train(j, jstats))
    assert _declines(out) == _declines(capsys.readouterr().out) == []
    keys = ("hits", "misses", "entries")
    assert [[s[k] for k in keys] for s in stats] == [
        [s[k] for k in keys] for s in jstats]


def _data_group_runs(tmp_path, runs, **kw):
    """The port's Trainer(data_group=) on 2 CPU workers over gloo, each
    (name, Trainer keywords) of runs in turn: {name: [rank 0's, rank 1's
    results]} (tests/torch_fused_worker.py)."""
    from lstm_rnn_tpu_torch.parallel import launch
    from tests.torch_fused_worker import train_worker
    _trainer(tmp_path, "port", **kw)  # writes the corpora
    ref = Network(LAYERS)
    ref.init_params(5)
    ds_kw = {"parallel_sequences": 3, "sort_by_length": True,
             "prefetch": False, "fraction_shuffling": True, "seed": 11,
             **(kw.get("ds_kw") or {})}
    files = (str(tmp_path / "tr.nc"),
             str(tmp_path / "va.nc") if kw.get("val") else None)
    launch.start(train_worker, [torch.device("cpu")] * 2,
                 (str(tmp_path), LAYERS, ref.params, files, ds_kw,
                  kw.get("epochs", 3), runs))
    return {name: [torch.load(tmp_path / f"{name}_rank{r}.pt",
                              weights_only=False) for r in range(2)]
            for name, _ in runs}


@pytest.mark.parametrize("fuse", [2, 8])
def test_data_group_fuses(tmp_path, capsys, fuse):
    """A data group of 2 CPU workers (B = 3 padded to 4, 2 rows a rank)
    with fuse K and the cache on: bit for bit its fuse-1 run, every rank
    the same, and within the JAX file's tolerance of the JAX Trainer's
    fused run on a 2-device data mesh, with its cache lookups and decline
    lines (fuse 2 declines the training pass's stacked epoch and stacks
    the validation set, fuse 8 stacks both). The stacked entries hold the
    rank's block of each fraction, and no note is printed."""
    from lstm_rnn_tpu.parallel.mesh import make_mesh
    from lstm_rnn_tpu_torch.parallel.data import local_block, pad_batch
    kw = {"lengths": TWO_BUCKETS, "ds_kw": {"bucket_lengths": True},
          "val": True, "epochs": 2}
    res = _data_group_runs(tmp_path, [
        ("one", {}), ("fused", {"fuse_fractions": fuse,
                                "device_cache": True})], **kw)
    one, fused = res["one"], res["fused"]
    for r in range(2):
        _assert_bitwise((fused[r]["rows"], fused[r]["params"]),
                        (one[0]["rows"], one[0]["params"]))
        assert "one fraction at a time" not in fused[r]["out"]
    capsys.readouterr()
    j = _trainer(tmp_path, "jax", fuse_fractions=fuse, device_cache=True,
                 mesh=make_mesh(2), **kw)
    jstats = []
    _assert_close_to_jax((fused[0]["rows"], fused[0]["params"]),
                         _train(j, jstats))
    assert _declines(fused[0]["out"]) == _declines(
        capsys.readouterr().out)
    assert len(_declines(fused[0]["out"])) == (1 if fuse == 2 else 0)
    keys = ("hits", "misses", "entries")
    assert [[s[k] for k in keys] for s in fused[0]["stats"]] == [
        [s[k] for k in keys] for s in jstats]
    # the entries hold each rank's block of the padded fraction
    frames = {}
    for which, f in (("train", "tr.nc"), ("val", "va.nc")):
        ds = DataSet([str(tmp_path / f)], parallel_sequences=3,
                     sort_by_length=True, prefetch=False,
                     bucket_lengths=True)
        frames[which] = {frac.key[1:]: pad_batch(
            frac.inputs, frac.targets, frac.pattypes, 2)
            for frac in ds.fractions()}
    assert [sorted(r["stacked"]) for r in fused] == 2 * [
        ["train", "val"] if fuse == 8 else ["val"]]
    for r in range(2):
        for which, entry in fused[r]["stacked"].items():
            assert sorted(entry) == sorted(frames[which])
            for key, rows in entry.items():
                want = frames[which][key]
                assert rows[0].shape[1] == 2
                for a, b in zip(rows, want):
                    np.testing.assert_array_equal(a, local_block(b, r, 2))


def test_remat_fused_and_checkpoint_rng_state(tmp_path, monkeypatch):
    """--remat_blocks 2: the stacked epoch equals the unfused run bit for
    bit. The blocks' checkpoints no longer save the RNG state
    (preserve_rng_state=False, which keeps it out of a step graph's
    capture); the blocks draw no random numbers, so a step's loss and
    gradients are bit for bit those of checkpoints that save it."""
    kw = {"remat_blocks": 2, "val": True}
    want = _train(_trainer(tmp_path, "port", **kw))
    got = _train(_trainer(tmp_path, "port", fuse_fractions=8,
                          device_cache=True, **kw))
    _assert_bitwise(got, want)

    import torch.utils.checkpoint as tc

    from lstm_rnn_tpu_torch.models import blocks
    seen = []

    def run(preserve):
        def checkpoint(*a, **k):
            seen.append(k["preserve_rng_state"])
            k["preserve_rng_state"] = preserve
            return tc.checkpoint(*a, **k)

        monkeypatch.setattr(blocks, "checkpoint", checkpoint)
        t = _trainer(tmp_path, "port", remat_blocks=2)
        frac = next(iter(t.train_set.fractions()))
        batch = t._device_batch(frac)
        err, _, grads = t.grad_fraction(*batch)
        return err, t._leaves(grads)

    err_false, g_false = run(False)
    err_true, g_true = run(True)
    assert seen and not any(seen)  # the blocks pass False
    assert torch.equal(err_false, err_true)
    for a, b in zip(g_false, g_true):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fuse", ["2", "8"])
def test_cli_fuse_fractions_reads_as_the_jax_cli(tmp_path, capsys,
                                                 monkeypatch, fuse):
    """cli.main in train mode with --fuse_fractions K --device_cache true
    (3 training fractions of 2 sequences, 2 validation fractions): the
    trained network byte for byte the run's without the flags, and the
    epoch rows' cache brackets and the decline lines the JAX CLI's. Fuse
    2 declines the training pass's stacked epoch and stacks the
    validation set, fuse 8 stacks both."""
    from lstm_rnn_tpu import cli as jax_cli
    from lstm_rnn_tpu.trainer import Trainer as JaxTrainer
    from lstm_rnn_tpu_torch import cli
    from tests.test_torch_cli import _train_args
    # the JAX Trainer's whole-epoch compile on the calling thread, as
    # tests/test_fused.py has it: in the background its first stacked
    # pass may decline for the compile's sake, which the port (no
    # background compile) never does
    monkeypatch.setattr(JaxTrainer, "_spawn_warm_compile",
                        lambda self, stacks, update: None)

    def args(name):
        return _train_args(tmp_path, str(tmp_path / name)) + [
            "--parallel_sequences", "2"]

    flags = ["--fuse_fractions", fuse, "--device_cache", "true"]
    assert cli.main(args("plain.jsn")) == 0
    capsys.readouterr()
    assert cli.main(args("port.jsn") + flags) == 0
    out = capsys.readouterr().out
    assert jax_cli.main(args("jax.jsn") + flags) == 0
    out_jax = capsys.readouterr().out
    assert ((tmp_path / "port.jsn").read_bytes()
            == (tmp_path / "plain.jsn").read_bytes())
    brackets = re.findall(r"\[cache .*\]", out)
    assert brackets == re.findall(r"\[cache .*\]", out_jax) == [
        "[cache 0/5 hit, 0 MiB]", "[cache 5/5 hit, 0 MiB]"]
    assert _declines(out) == _declines(out_jax) == (
        ["Epoch-resident fast path declined: fuse_fractions=2 < 3 "
         "fractions — raise --fuse_fractions to cover the whole pass"]
        if fuse == "2" else [])


def test_graph_pools_count_against_the_cache_budget(tmp_path, capsys):
    """The step graphs' pools come off the device cache's budget
    (`_cache_room`): with pools as large as the budget the stacked epoch
    declines on the budget, naming no room left, and no fraction is
    cached; the values stay the plain run's."""
    import types
    want = _train(_trainer(tmp_path, "port", epochs=2))
    t = _trainer(tmp_path, "port", fuse_fractions=8, device_cache=True,
                 device_cache_bytes=1 << 20, epochs=2)
    t._graphs["pool"] = types.SimpleNamespace(pool_bytes=3 << 18,
                                              release=lambda: None)
    assert t._cache_room() == 1 << 18
    t._graphs["pool"].pool_bytes = 1 << 20
    stats = []
    _assert_bitwise(_train(t, stats), want)
    assert [(s["misses"], s["entries"]) for s in stats] == [(4, 0), (4, 0)]
    assert _declines(capsys.readouterr().out) == [
        f"{DECLINED}: stacked corpus needs ~0.00 GiB but only 0.00 GiB of "
        "device_cache_bytes remain (budget 0.00 GiB)"]


def test_graph_stats_count_each_replay():
    """The launch counters come from ops/ (the wrappers' `.launches`, the
    engine's per product), and `GraphStats.executed` counts a capture's
    recorded launches once a replay in place of the once the wrappers
    saw them: 10 eager launches and two captures of 5 and 2, the first
    replayed 3 times, the second dropped unreplayed, ran 25 kernels."""
    from lstm_rnn_tpu_torch.graphs import GraphStats, launch_counters
    from lstm_rnn_tpu_torch.ops import gemm, lstm_cell, softmax_ce
    counters = launch_counters()
    assert counters["lstm_bwd"] is lstm_cell.lstm_bwd
    assert counters["softmax_ce_proj_fwd"] is softmax_ce.softmax_ce_proj_fwd
    assert counters["WIDE_BWD_3X"] is softmax_ce.WIDE_BWD_3X
    assert counters["gemm:proj:3x"] is gemm.LAUNCHES["proj:3x"]
    st = GraphStats()
    st.log = [{"launches": {"lstm_bwd": 5}, "replays": 3},
              {"launches": {"lstm_bwd": 2, "gemm:proj": 1}, "replays": 0}]
    assert st.executed("lstm_bwd", 10 + 5 + 2) == 25
    assert st.executed("gemm:proj", 1) == 0
    assert st.executed("softmax_ce_fwd", 4) == 4
