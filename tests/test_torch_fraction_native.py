"""The port's native fraction assembly (lstm_rnn_tpu_torch/runtime/
fraction.cpp, built with g++ at first use) against the JAX package's
native assembly and the port's NumPy path, byte for byte, on corpora made
from a seed: the cases of tests/test_native_runtime.py and the DataSet's
other paths into it (a one-frame sequence, lags past the sequence, a short
last fraction, length buckets, a spilled disk cache). Then the DataSet's
`use_native` gate against the JAX DataSet's, a library that does not
build, the checks on out=, and the Trainer's assembly straight into its
staging buffer on a device-cache miss, bit for bit the copy's."""

import os

import numpy as np
import pytest
import torch

from lstm_rnn_tpu import runtime as jax_runtime
from lstm_rnn_tpu.data.dataset import DataSet as JaxDataSet
from lstm_rnn_tpu_torch import runtime
from lstm_rnn_tpu_torch.data.dataset import DataSet, LazyFraction, _file_rows
from lstm_rnn_tpu_torch.data.netcdf3 import strings_to_chars, write_netcdf
from lstm_rnn_tpu_torch.network import Network
from lstm_rnn_tpu_torch.parallel.data import DataGroup, local_block, pad_batch
from lstm_rnn_tpu_torch.trainer import Trainer
from tests.test_data import _write_classification_nc
from tests.test_torch_native_runtime import fresh_runtime  # noqa: F401

LENGTHS = [7, 3, 5, 9, 4]


def _write_regression_nc(path, lengths, in_size=3, out_size=2, seed=4):
    rng = np.random.RandomState(seed)
    n = sum(lengths)
    dims = {"numSeqs": len(lengths), "numTimesteps": n,
            "inputPattSize": in_size, "targetPattSize": out_size,
            "maxSeqTagLength": 8}
    tags = strings_to_chars([f"r{i}" for i in range(len(lengths))], 8)
    write_netcdf(path, dims, [
        ("seqTags", ["numSeqs", "maxSeqTagLength"], tags),
        ("seqLengths", ["numSeqs"], np.asarray(lengths, np.int32)),
        ("inputs", ["numTimesteps", "inputPattSize"],
         rng.randn(n, in_size).astype(np.float32)),
        ("targetPatterns", ["numTimesteps", "targetPattSize"],
         rng.randn(n, out_size).astype(np.float32)),
    ])


CASES = {
    "plain": ({}, {}),
    "context_2_1": ({}, {"input_left_context": 2,
                         "input_right_context": 1}),
    "lag_2": ({}, {"output_time_lag": 2}),
    "regression_lag_1": ({"regression": True}, {"output_time_lag": 1}),
    # lag 5 >= L + 2 for the sequences of 3 frames (and of 1 and 2 below)
    "lag_past_the_sequence": ({"lengths": [3, 1, 2, 8]},
                              {"output_time_lag": 5}),
    "regression_lag_past": ({"regression": True, "lengths": [3, 1, 9]},
                            {"output_time_lag": 4}),
    "one_frame": ({"lengths": [1, 4, 1, 1, 6]},
                  {"input_left_context": 1, "input_right_context": 1}),
    # 5 sequences in fractions of 3: the last holds 2
    "short_last": ({}, {"parallel_sequences": 3}),
    "buckets": ({"lengths": [7, 30, 5, 17, 21, 2]},
                {"bucket_lengths": True, "input_left_context": 1}),
    "disk_cache": ({}, {"cache_path": True, "output_time_lag": 1,
                        "input_right_context": 2}),
    # the third fraction holds a sequence of each file
    "two_files": ({"files": 2}, {"input_left_context": 1}),
}


def _corpus(tmp_path, regression=False, lengths=LENGTHS, files=1):
    paths = [str(tmp_path / f"c{i}.nc") for i in range(files)]
    for i, path in enumerate(paths):
        if regression:
            _write_regression_nc(path, lengths)
        else:
            _write_classification_nc(path, lengths, in_size=3,
                                     num_labels=4, seed=6 + i)
    return paths


def _kwargs(tmp_path, kw):
    kw = {"parallel_sequences": 2, **kw}
    if kw.get("cache_path"):
        kw["cache_path"] = str(tmp_path)
    return kw


def _assert_same(a, b):
    np.testing.assert_array_equal(a.inputs, b.inputs)
    np.testing.assert_array_equal(a.targets, b.targets)
    np.testing.assert_array_equal(a.pattypes, b.pattypes)
    for x, y in ((a.inputs, b.inputs), (a.targets, b.targets),
                 (a.pattypes, b.pattypes)):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    assert a.seq_info == b.seq_info


@pytest.mark.parametrize("case", list(CASES))
def test_native_fractions_match_jax_and_numpy(tmp_path, case):
    """The port's native fractions (assembled on the prefetch thread) are
    byte for byte the port's NumPy fractions and the JAX DataSet's native
    ones (lstm_rnn_tpu.runtime.assemble_fraction), with the same seq_info
    and keys; runtime.assemble_fraction called directly on a fraction's
    sequences gives the JAX function's bytes too."""
    corpus_kw, kw = CASES[case]
    paths = _corpus(tmp_path, **corpus_kw)
    kw = _kwargs(tmp_path, kw)
    nat = DataSet(paths, use_native=True, **kw)
    py = DataSet(paths, use_native=False, prefetch=False, **kw)
    jax = JaxDataSet(paths, use_native=True, prefetch=False, **kw)
    assert nat._native is runtime and py._native is None
    assert jax._native is jax_runtime
    assert (nat._cache is not None) == bool(kw.get("cache_path"))
    fracs = list(zip(nat.fractions(), py.fractions(), jax.fractions()))
    assert len(fracs) == nat.num_fractions() > 1
    for fn, fp, fj in fracs:
        _assert_same(fn, fp)
        _assert_same(fn, fj)
        assert fn.key[1:] == fp.key[1:] == fj.key[1:]
        assert fn.key[0] == nat._cache_token
    # the binding itself, on the last fraction's sequences
    last = fracs[-1][0]
    b = nat.parallel_sequences
    seqs = nat.sequences[(nat.num_fractions() - 1) * b:]
    arrs = [nat._seq_arrays(s) for s in seqs]
    # a file held in RAM is read where it lies, a spilled one gathered
    assert (_file_rows(arrs) is None) == (case == "disk_cache")
    lengths = np.asarray([s.length for s in seqs], np.int32)
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int32)
    args = (np.concatenate([a[0] for a in arrs]),
            np.concatenate([a[1] for a in arrs]), offsets, lengths,
            nat.is_classification, last.inputs.shape[0], b,
            nat.input_pattern_size, nat.output_pattern_size,
            nat.left_context, nat.right_context, nat.output_time_lag)
    for x, y, z in zip(runtime.assemble_fraction(*args),
                       jax_runtime.assemble_fraction(*args),
                       (last.inputs, last.targets, last.pattypes)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes() == z.tobytes()


@pytest.mark.parametrize("noise", [0.0, 0.1])
def test_use_native_gate_matches_jax(tmp_path, noise):
    """use_native=None takes the native assembly exactly when the JAX
    DataSet does (no input noise); forced on under noise, both keep the
    NumPy path (its noise stream), the same bytes as use_native=False
    under the same seed."""
    path = _corpus(tmp_path)[0]
    kw = {"parallel_sequences": 2, "noise_deviation": noise, "seed": 3,
          "prefetch": False}
    port, jax = DataSet([path], **kw), JaxDataSet([path], **kw)
    assert (port._native is not None) == (jax._native is not None) \
        == (noise == 0.0)
    forced = DataSet([path], use_native=True, **kw)
    assert forced._native is runtime
    assert JaxDataSet([path], use_native=True, **kw)._native is not None
    assert forced._assembles_natively() == (noise == 0.0)
    for a, b in zip(forced.fractions(),
                    DataSet([path], use_native=False, **kw).fractions()):
        _assert_same(a, b)


def test_broken_build(fresh_runtime, tmp_path, capsys,  # noqa: F811
                      monkeypatch):
    """A library that does not build: use_native=True raises with g++'s
    message; use_native=None says so once on stderr (for every DataSet of
    the process) and assembles with NumPy, the same bytes."""
    path = _corpus(tmp_path)[0]
    want = list(DataSet([path], parallel_sequences=2,
                        use_native=False).fractions())
    monkeypatch.setattr(runtime, "CXX_FLAGS",
                        runtime.CXX_FLAGS + ("-fno-such-option",))
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*"
                                           "fno-such-option"):
        DataSet([path], parallel_sequences=2, use_native=True)
    capsys.readouterr()
    sets = [DataSet([path], parallel_sequences=2) for _ in range(2)]
    err = capsys.readouterr().err
    assert err.count("the native runtime is unavailable") == 1
    assert "fno-such-option" in err
    for ds in sets:
        assert ds._native is None
        for a, b in zip(ds.fractions(), want):
            _assert_same(a, b)
    assert not os.listdir(fresh_runtime)  # no library, no leftover


def _args(b=3, t_pad=10):
    rng = np.random.RandomState(2)
    lengths = np.asarray([6, 10], np.int32)
    return (rng.randn(16, 4).astype(np.float32),
            rng.randint(0, 5, 16).astype(np.int32),
            np.asarray([0, 6], np.int32), lengths, True, t_pad, b, 4, 1, 1,
            0, 0)


def test_assemble_into_out_arrays():
    """out= arrays are written in place (every byte, whatever they held)
    and returned; the result is the new arrays' bytes."""
    want = runtime.assemble_fraction(*_args())
    out = (np.full((10, 3, 8), np.nan, np.float32),
           np.full((10, 3), 7, np.int32), np.full((10, 3), 9, np.int8))
    got = runtime.assemble_fraction(*_args(), out=out)
    assert all(g is o for g, o in zip(got, out))
    for g, w in zip(got, want):
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("bad", ["dtype", "shape", "strided", "readonly",
                                 "list"])
def test_out_arrays_are_checked(bad):
    """An out= array of another dtype or shape, a view that is not
    C-contiguous, a read-only array or a non-array raises ValueError;
    nothing is copied."""
    out = [np.empty((10, 3, 8), np.float32), np.empty((10, 3), np.int32),
           np.empty((10, 3), np.int8)]
    if bad == "dtype":
        out[1] = np.empty((10, 3), np.int64)
    elif bad == "shape":
        out[2] = np.empty((10, 4), np.int8)
    elif bad == "strided":
        out[0] = np.empty((10, 3, 16), np.float32)[:, :, ::2]
    elif bad == "readonly":
        out[1].flags.writeable = False
    else:
        out[2] = np.empty((10, 3), np.int8).tolist()
    with pytest.raises(ValueError, match="out .* must be a writeable "
                                         "C-contiguous"):
        runtime.assemble_fraction(*_args(), out=tuple(out))


def test_sequences_must_fit_the_fraction():
    """More sequences than rows, or a sequence longer than t_pad, raises
    before the call."""
    with pytest.raises(ValueError, match="do not fit"):
        runtime.assemble_fraction(*_args(b=1))
    with pytest.raises(ValueError, match="do not fit"):
        runtime.assemble_fraction(*_args(t_pad=8))


def test_numpy_path_refuses_out(tmp_path):
    """out= belongs to the native path: a DataSet on the NumPy path
    refuses it rather than copying."""
    ds = DataSet(_corpus(tmp_path), parallel_sequences=2,
                 use_native=False)
    frac = next(ds.lazy_fractions())
    assert frac.native_layout() is None
    with pytest.raises(ValueError, match="native"):
        frac.assemble_into(*(np.empty(s, d) for d, s in ds.host_layout(
            frac.shape)))


# ------------------------------------------------- the Trainer's staging path
LAYERS = [
    {"name": "input", "type": "input", "size": 3},
    {"name": "l1", "type": "blstm", "size": 4, "bias": 1.0},
    {"name": "output", "type": "softmax", "size": 4, "bias": 1.0},
    {"name": "postoutput", "type": "multiclass_classification", "size": 4},
]
TRAIN_LENGTHS = [8] * 7 + [20] * 4 + [12] * 6
VAL_LENGTHS = [5, 9, 7, 14, 3]


def _staged_run(tmp_path, native, monkeypatch, dtype="float32", **kw):
    """Two epochs with the device cache on and a budget of 0 bytes (every
    lookup a miss): the trained parameters, the device batches of every
    lookup, the LazyFractions fed, the cache's stats a pass and the bytes
    copied; assemble_into's calls."""
    tr_nc, va_nc = str(tmp_path / "tr.nc"), str(tmp_path / "va.nc")
    _write_classification_nc(tr_nc, TRAIN_LENGTHS, in_size=3, num_labels=4,
                             seed=2)
    _write_classification_nc(va_nc, VAL_LENGTHS, in_size=3, num_labels=4,
                             seed=9)
    ds_kw = {"parallel_sequences": 3, "sort_by_length": True,
             "fraction_shuffling": True, "seed": 11, "bucket_lengths": True,
             "use_native": native}
    net = Network(LAYERS, **({"backend": "scan", "compute_dtype": "float64"}
                             if dtype == "float64" else {}))
    net.init_params(5)
    t = Trainer(net, DataSet([tr_nc], **ds_kw), DataSet([va_nc], **ds_kw),
                learning_rate=0.05, momentum=0.9, max_epochs=2,
                hybrid_online_batch=True, device="cpu", device_cache=True,
                device_cache_bytes=0, **kw)
    fed, batches, stats, calls = [], [], [], []
    orig_batch, orig_into = t._device_batch, LazyFraction.assemble_into

    def device_batch(frac):
        fed.append(frac)
        batch = orig_batch(frac)
        batches.append([b.clone() for b in batch])
        return batch

    def assemble_into(self, *views):
        calls.append(self.key)
        return orig_into(self, *views)

    monkeypatch.setattr(t, "_device_batch", device_batch)
    monkeypatch.setattr(LazyFraction, "assemble_into", assemble_into)
    while not t.train_epoch():
        stats.append(t.device_cache_stats())
    stats.append(t.device_cache_stats())
    monkeypatch.setattr(LazyFraction, "assemble_into", orig_into)
    params = {n: {k: v.detach().clone() for k, v in layer.items()}
              for n, layer in t.params.items()}
    return params, batches, fed, stats, t.h2d_bytes, calls


def _assert_runs_equal(a, b):
    for n in a[0]:
        for k in a[0][n]:
            assert torch.equal(a[0][n][k], b[0][n][k]), (n, k)
    assert len(a[1]) == len(b[1]) > 0
    for x, y in zip(a[1], b[1]):
        for u, v in zip(x, y):
            assert u.dtype == v.dtype and torch.equal(u, v)
    assert a[3] == b[3] and a[4] == b[4]


def test_staging_path_trains_bit_for_bit(tmp_path, monkeypatch):
    """With the cache on and a budget that admits nothing, every lookup
    misses and each LazyFraction is assembled natively straight into the
    staging buffer: the batches, the cache's stats, the bytes copied and
    the trained parameters are bit for bit those of use_native=False
    (which assembles with NumPy and copies); the fractions fed never
    materialised their arrays, and a later access assembles the same
    bytes."""
    got = _staged_run(tmp_path, True, monkeypatch)
    want = _staged_run(tmp_path, False, monkeypatch)
    _assert_runs_equal(got, want)
    assert all(s["hits"] == 0 and s["misses"] > 0 and s["entries"] == 0
               for s in got[3])
    fed, calls = got[2], got[5]
    assert all(isinstance(f, LazyFraction) for f in fed)
    assert len(calls) == len(fed) == sum(s["misses"] for s in got[3])
    assert all(f._real is None for f in fed)
    assert not want[5]  # the NumPy path copies
    for f, batch in zip(fed[-3:], got[1][-3:]):
        np.testing.assert_array_equal(f.inputs, batch[0].numpy())
        np.testing.assert_array_equal(f.targets, batch[1].numpy())
        np.testing.assert_array_equal(f.pattypes, batch[2].numpy())


def test_float64_trainer_copies(tmp_path, monkeypatch):
    """float64 parameters stage the inputs as float64: the native path
    assembles into its own arrays, which the Trainer copies; the run is
    bit for bit the NumPy path's."""
    got = _staged_run(tmp_path, True, monkeypatch, dtype="float64")
    want = _staged_run(tmp_path, False, monkeypatch, dtype="float64")
    _assert_runs_equal(got, want)
    assert got[1][0][0].dtype == torch.float64
    assert not got[5]


def test_data_group_block_copies(tmp_path, monkeypatch):
    """Under a data group that splits the fraction the rank's block is
    copied: no assembly into the staging buffer, and the device batch is
    the block of the NumPy fraction."""
    path = _corpus(tmp_path)[0]
    net = Network(LAYERS)
    net.init_params(5)
    t = Trainer(net, None, device="cpu", device_cache=True,
                device_cache_bytes=0,
                data_group=DataGroup(1, 2, torch.device("cpu")))
    calls = []
    monkeypatch.setattr(LazyFraction, "assemble_into",
                        lambda self, *v: calls.append(v))
    ds = DataSet([path], parallel_sequences=3, use_native=True)
    ref = DataSet([path], parallel_sequences=3, use_native=False,
                  prefetch=False)
    for frac, want in zip(ds.lazy_fractions(), ref.fractions()):
        assert t._native_layout(frac) is None
        batch = t._device_batch(frac)
        block = [local_block(a, 1, 2) for a in pad_batch(
            want.inputs, want.targets, want.pattypes, 2)]
        for u, v in zip(batch, block):
            np.testing.assert_array_equal(u.numpy(), v)
    assert not calls and t.cache_misses == ds.num_fractions()
