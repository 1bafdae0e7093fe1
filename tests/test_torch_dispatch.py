"""The port's data feed in the Trainer (lstm_rnn_tpu_torch/trainer.py):
the device cache and the lazy fractions behind it, against the same
Trainer without them (bit for bit on the CPU) and against the JAX
package's Trainer and DataSet. The cases of tests/test_fused.py that are
not about fused groups, the JAX package's stacked epoch or its TPU
budgets. The CLI's flags: tests/test_torch_cli.py."""

import numpy as np
import pytest

from lstm_rnn_tpu.data.dataset import DataSet as JaxDataSet
from lstm_rnn_tpu.network import Network as JaxNetwork
from lstm_rnn_tpu.trainer import Trainer as JaxTrainer
from lstm_rnn_tpu_torch.data.dataset import DataSet, LazyFraction
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
# 6 fractions of 3 in two length buckets: 4 of 16 frames, then 2 of 24,
# the last of them short (2 sequences); validation: 2 fractions of 16
TRAIN_LENGTHS = [8] * 7 + [20] * 4 + [12] * 6
VAL_LENGTHS = [5, 9, 7, 14, 3]


def _corpus(tmp_path):
    tr, va = str(tmp_path / "tr.nc"), str(tmp_path / "va.nc")
    _write_classification_nc(tr, TRAIN_LENGTHS, in_size=3, num_labels=4,
                             seed=2)
    _write_classification_nc(va, VAL_LENGTHS, in_size=3, num_labels=4,
                             seed=9)
    return tr, va


def _trainer(tmp_path, pkg="port", epochs=2, layers=LAYERS, val=True,
             ds_kw=None, remat_blocks=0, hybrid=True, **kw):
    tr, va = _corpus(tmp_path)
    ds_kw = {"parallel_sequences": 3, "sort_by_length": True,
             "prefetch": False, "fraction_shuffling": True, "seed": 11,
             "bucket_lengths": True, **(ds_kw or {})}
    if pkg == "jax":
        DS, Net, Tr, extra = JaxDataSet, JaxNetwork, JaxTrainer, {}
    else:
        DS, Net, Tr, extra = DataSet, Network, Trainer, {"device": "cpu"}
    net = Net(layers)
    net.init_params(5)
    net.remat_blocks = remat_blocks
    return Tr(net, DS([tr], **ds_kw),
              DS([va], **ds_kw) if val else None, learning_rate=0.05,
              momentum=0.9, max_epochs=epochs, hybrid_online_batch=hybrid,
              **extra, **kw)


def _train(t):
    rows = []
    done = False
    while not done:
        done = t.train_epoch()
        rows.append((t.cur_training_error, t.cur_training_class_error,
                     t.cur_validation_error, t.cur_validation_class_error))
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
    # true f32 on both sides, sums in another order (test_torch_trainer)
    np.testing.assert_allclose(port[0], jax[0], rtol=1e-5, atol=1e-6)
    for n in jax[1]:
        for k in jax[1][n]:
            np.testing.assert_allclose(port[1][n][k], jax[1][n][k], rtol=0,
                                       atol=1e-5, err_msg=f"{n}/{k}")


@pytest.mark.parametrize("hybrid", [True, False],
                         ids=["stochastic", "batch"])
def test_cached_equals_uncached(tmp_path, hybrid):
    """device_cache=True over 3 epochs with shuffled fractions, in
    stochastic and in batch mode: the same errors and weights bit for
    bit, epochs 2 and 3 all hits and no byte copied from the host in any
    of their passes; the JAX Trainer's cached run within the port's f32
    tolerance, with the same lookups."""
    want = _train(_trainer(tmp_path, epochs=3, hybrid=hybrid))
    t = _trainer(tmp_path, epochs=3, hybrid=hybrid, device_cache=True)
    stats = []
    orig = t.train_epoch

    def epoch():
        done = orig()
        stats.append(t.device_cache_stats())
        return done

    t.train_epoch = epoch
    got = _train(t)
    _assert_bitwise(got, want)
    assert [(s["hits"], s["misses"]) for s in stats] == [(0, 8), (8, 0),
                                                         (8, 0)]
    assert stats[0]["entries"] == stats[2]["entries"] == 8
    assert len(t.h2d_bytes) == 6 and t.h2d_bytes[0] > 0
    assert t.h2d_bytes[2:] == [0, 0, 0, 0]
    j = _trainer(tmp_path, "jax", epochs=3, hybrid=hybrid, device_cache=True)
    _assert_close_to_jax(got, _train(j))
    # the same lookups and entries (the JAX Trainer pads B to 8 rows:
    # other bytes)
    keys = ("hits", "misses", "entries")
    assert ([j.device_cache_stats()[k] for k in keys]
            == [t.device_cache_stats()[k] for k in keys])


def test_device_cache_budget_pins_prefix_stats_equal_jax(tmp_path):
    """A corpus 1.5x the cache budget: the admitted prefix stays (a cyclic
    epoch would thrash a least-recently-used cache to no hit at all), and
    device_cache_stats() equals the JAX Trainer's, epoch by epoch, for
    the same corpus and budget (fractions of 16 frames and 8 sequences,
    which the JAX Trainer pads to nothing: the same bytes); an entry
    unused for two epochs is evicted when the budget needs its bytes."""
    tr = str(tmp_path / "tr.nc")
    _write_classification_nc(tr, [16] * 48, in_size=3, num_labels=4, seed=1)
    layers = [dict(LAYERS[1], type="lstm") if i == 1 else layer
              for i, layer in enumerate(LAYERS)]

    def make(pkg, budget=None, epochs=4):
        DS, Net, Tr, extra = ((JaxDataSet, JaxNetwork, JaxTrainer, {})
                              if pkg == "jax" else
                              (DataSet, Network, Trainer, {"device": "cpu"}))
        net = Net(layers)
        net.init_params(3)
        return Tr(net, DS([tr], parallel_sequences=8, sort_by_length=True,
                          prefetch=False),
                  learning_rate=1e-3, max_epochs=epochs,
                  hybrid_online_batch=True, device_cache=True,
                  device_cache_bytes=budget, **extra)

    full = make("port", epochs=1)
    full.train_epoch()
    full_bytes = full._dev_cache_bytes
    assert full_bytes == 6 * 16 * 8 * (3 * 4 + 4 + 1)
    budget = int(full_bytes / 1.5) + 1
    t, j = make("port", budget), make("jax", budget)
    for epoch in range(3):
        t.train_epoch()
        j.train_epoch()
        st = t.device_cache_stats()
        assert st == j.device_cache_stats()
        assert st["entries"] == 4 and st["bytes"] <= budget
        assert (st["hits"], st["misses"]) == ((0, 6) if epoch == 0
                                              else (4, 2))
    dead = ("dead-token", 0)
    t._dev_cache[dead] = [t._dev_cache[next(iter(t._dev_cache))][0],
                          full_bytes, t.cur_epoch - 2]
    t._dev_cache_bytes += full_bytes
    t.train_epoch()  # over the budget: the stale entry goes
    assert dead not in t._dev_cache and t._dev_cache_bytes <= budget


def test_device_cache_keys_not_shared_across_datasets(tmp_path):
    """Each DataSet namespaces its fractions' keys: a validation fraction
    never hits the training fraction cached under the same sequence ids,
    so the cached run's validation errors are the uncached run's."""
    want = _train(_trainer(tmp_path, ds_kw={"bucket_lengths": False}))
    t = _trainer(tmp_path, ds_kw={"bucket_lengths": False},
                 device_cache=True)
    got = _train(t)
    _assert_bitwise(got, want)
    keys = list(t._dev_cache)
    assert len(keys) == 6 + 2 and len({k[0] for k in keys}) == 2
    assert {k[1:] for k in keys if k[0] == keys[0][0]} & {
        k[1:] for k in keys if k[0] != keys[0][0]}  # shared ids, apart


def test_uncacheable_sets_are_not_cached(tmp_path):
    """Input noise and sequence shuffling change a fraction's contents
    every epoch: no key, nothing cached, eager fractions; the runs equal
    the uncached ones."""
    for ds_kw in ({"noise_deviation": 0.1}, {"sequence_shuffling": True}):
        want = _train(_trainer(tmp_path, val=False, ds_kw=ds_kw))
        t = _trainer(tmp_path, val=False, ds_kw=ds_kw, device_cache=True)
        assert t.train_set.fraction_meta(0)[0] is None
        got = _train(t)
        assert len(t._dev_cache) == 0
        assert t.device_cache_stats()["misses"] == 0
        _assert_bitwise(got, want)


def test_lazy_fractions_match_fractions_and_jax(tmp_path):
    """lazy_fractions hands out the keys, shapes and (on first access) the
    arrays of fractions(), with the same shuffles, the short last
    fraction at the full width; the JAX DataSet's lazy handles have the
    same keys (after the DataSet token) and shapes."""
    tr, _ = _corpus(tmp_path)
    kw = {"parallel_sequences": 3, "sort_by_length": True, "prefetch": False,
          "fraction_shuffling": True, "seed": 11, "bucket_lengths": True}
    eager, lazy, jx = DataSet([tr], **kw), DataSet([tr], **kw), \
        JaxDataSet([tr], **kw)
    for _ in range(3):
        fe = list(eager.fractions())
        fl = list(lazy.lazy_fractions())
        fj = list(jx.lazy_fractions())
        assert all(isinstance(f, LazyFraction) for f in fl)
        assert [f.shape for f in fl] == [f.shape for f in fe] == [
            f.shape for f in fj]
        assert [f.key[1:] for f in fl] == [f.key[1:] for f in fe] == [
            f.key[1:] for f in fj]
        assert fl[-1].shape[1] == 3 and len(fl[-1].seq_info) <= 3
        for a, b in zip(fl, fe):
            np.testing.assert_array_equal(a.inputs, b.inputs)
            np.testing.assert_array_equal(a.targets, b.targets)
            np.testing.assert_array_equal(a.pattypes, b.pattypes)
    # bucket-major shuffling: the buckets come out one after the other
    shapes = [f.shape for f in lazy.lazy_fractions()]
    runs = 1 + sum(1 for a, b in zip(shapes, shapes[1:]) if a != b)
    assert runs == len(set(shapes)) == 2


def test_explicit_bucket_inventory(tmp_path):
    """An explicit bucket inventory pads each fraction up to the next
    bucket, and a fraction above the largest to its exact length, as the
    JAX DataSet's lazy shapes say."""
    tr = str(tmp_path / "tr.nc")
    _write_classification_nc(tr, [8, 8, 8, 20, 20, 20, 40, 40, 40],
                             in_size=3, num_labels=4, seed=4)
    kw = {"parallel_sequences": 3, "sort_by_length": True, "prefetch": False,
          "bucket_lengths": (12, 24)}
    tps = sorted(f.shape[0] for f in DataSet([tr], **kw).lazy_fractions())
    assert tps == [12, 24, 40] == sorted(
        f.shape[0] for f in JaxDataSet([tr], **kw).lazy_fractions())


@pytest.mark.parametrize("route", ["remat", "seq"])
def test_cached_under_remat_and_seq_mesh(tmp_path, route):
    """A cached run under --remat_blocks 2 and on a 2-block seq mesh of
    the CPU: the same steps as the uncached run, bit for bit, epoch 2
    copying nothing."""
    def make(**kw):
        if route == "seq":
            return _trainer(tmp_path, seq_mesh=make_seq_mesh(2, "cpu"), **kw)
        return _trainer(tmp_path, remat_blocks=2, **kw)

    want = _train(make())
    t = make(device_cache=True)
    _assert_bitwise(_train(t), want)
    assert t.h2d_bytes[0] > 0 and t.h2d_bytes[2:] == [0, 0]
