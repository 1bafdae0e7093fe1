"""The port's native runtime (lstm_rnn_tpu_torch/runtime: jsonfmt.cpp,
built with g++ at first use) against the port's Python path and the JAX
package's native runtime, on inputs made from a seed: the JSON byte for
byte (the JAX package's formatter writes other bytes for the same values,
so against it the values are held after parsing). The JSON cases of
tests/test_native_runtime.py, plus the port's build directory, its hash
and its failure handling."""

import io
import json
import math
import os
import shutil

import numpy as np
import pytest

from lstm_rnn_tpu import io_currennt as jax_ioc
from lstm_rnn_tpu import runtime as jax_runtime
from lstm_rnn_tpu_torch import io_currennt as ioc
from lstm_rnn_tpu_torch import runtime
from lstm_rnn_tpu_torch.network import Network
from lstm_rnn_tpu_torch.ops import _build


def _floats():
    """Doubles across the whole range (random bit patterns, both signs),
    their float32 roundings, and the edges of repr's notations."""
    rng = np.random.RandomState(3)
    bits = rng.randint(0, 2**63, size=20000, dtype=np.int64).view(np.float64)
    bits = bits[np.isfinite(bits)]
    a = np.concatenate([
        bits, -bits, rng.randn(4096) * np.logspace(-30, 30, 4096),
        np.arange(-600, 600) * 0.25, np.round(rng.randn(500) * 1e6),
        [0.0, -0.0, 1.0, -1.0, 0.1, 1e-4, 1e-5, 0.00012345, 1e15, 1e16,
         -1e16, 9999999999999998.0, 123456789012345678.0, 1e22, 1e100,
         1e-100, 5e-324, 2.2250738585072014e-308, 1.7976931348623157e308,
         np.nan, np.inf, -np.inf]])
    with np.errstate(over="ignore"):
        return np.concatenate([a, a.astype(np.float32).astype(np.float64)])


def test_fmt_f64_json_matches_repr():
    """runtime.fmt_f64_json writes json.dumps's bytes for the list of
    float64 values (Python's repr of each, NaN/Infinity as json.dump
    writes them) at every depth of a document dumped with indent 1 (and
    2); the JAX package's formatter writes the same values."""
    a = _floats()
    assert runtime.fmt_f64_json(a) == json.dumps(a.tolist(),
                                                 indent=1).encode()
    assert runtime.fmt_f64_json(a, indent=2) == json.dumps(
        a.tolist(), indent=2).encode()
    for level in range(1, 4):
        doc = a[:2000].tolist()
        for _ in range(level):
            doc = [doc]
        blob = runtime.fmt_f64_json(a[:2000], level=level)
        assert blob.decode() in json.dumps(doc, indent=1)
    assert runtime.fmt_f64_json(np.zeros(0)) == b"[]"
    got = json.loads(jax_runtime.fmt_f64_json(a).decode())
    want = json.loads(runtime.fmt_f64_json(a).decode())
    assert len(got) == len(want)
    for i, (x, y) in enumerate(zip(got, want)):
        assert (math.isnan(x) and math.isnan(y)) or x == y, (i, x, y)


def _doc():
    rng = np.random.RandomState(5)
    return {
        "configuration": "opt = value;;;other",
        "weights": {"l1": {"input": rng.randn(3000),
                           "bias": rng.randn(12),
                           "internal": rng.randn(700).astype(np.float32)}},
        "optimizer_best_weights": [rng.randn(2048), [], np.zeros(0),
                                   rng.randn(600) * 1e20],
        "nested": [[rng.randn(513)]],
        "grid": rng.randn(30, 30),
        "layers": [{"name": "l1", "type": "lstm", "size": 4}],
    }


def _dump(fn, doc):
    buf = io.StringIO()
    fn(doc, buf)
    return buf.getvalue()


def test_dump_doc_json_matches_pure_python():
    """dump_doc_json writes the pure-Python dump's bytes (arrays spliced in
    natively at their depth; small, 2-D and empty arrays through json),
    which are the JAX package's pure-Python bytes; the JAX package's
    native dump parses to the same doc."""
    doc = _doc()
    got = _dump(ioc.dump_doc_json, doc)
    assert got == _dump(ioc.dump_doc_json_python, doc)

    def pure(x):
        if isinstance(x, np.ndarray):
            return np.asarray(x, np.float64).tolist()
        if isinstance(x, dict):
            return {k: pure(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [pure(v) for v in x]
        return x

    assert got == json.dumps(pure(doc), indent=1)
    assert json.loads(got) == json.loads(_dump(jax_ioc.dump_doc_json, doc))


def test_dump_doc_json_preserves_integer_arrays():
    """Integer and bool arrays keep their parsed JSON types; float arrays
    widen to float64 (also the ones the native formatter takes)."""
    doc = {"ints": np.arange(600, dtype=np.int32),
           "flags": np.array([True, False]),
           "floats": np.arange(600, dtype=np.float32)}
    text = _dump(ioc.dump_doc_json, doc)
    assert text == _dump(ioc.dump_doc_json_python, doc)
    got = json.loads(text)
    assert got["ints"] == list(range(600))
    assert all(isinstance(v, int) for v in got["ints"])
    assert got["flags"] == [True, False]
    assert all(isinstance(v, float) for v in got["floats"])
    assert got == json.loads(_dump(jax_ioc.dump_doc_json, doc))


def test_dump_doc_json_token_collision_falls_back():
    """A doc string equal to a splice token takes the pure path whole."""
    arr = np.arange(600, dtype=np.float64)
    doc = {"evil": "@@LRT_JSONFMT_ARRAY_0@@", "w": arr}
    text = _dump(ioc.dump_doc_json, doc)
    assert text == _dump(ioc.dump_doc_json_python, doc)
    got = json.loads(text)
    assert got["evil"] == "@@LRT_JSONFMT_ARRAY_0@@"
    assert got["w"] == arr.tolist()


def test_saved_network_bytes_unchanged(tmp_path, monkeypatch):
    """A network file (weights handed out as float64 arrays) is byte for
    byte the one the pure-Python dump writes."""
    layers = [{"name": "input", "type": "input", "size": 40},
              {"name": "l1", "type": "blstm", "size": 20, "bias": 1.0},
              {"name": "output", "type": "softmax", "size": 30,
               "bias": 1.0},
              {"name": "postoutput", "type": "multiclass_classification",
               "size": 30}]
    net = Network(layers)
    net.init_params(7)
    weights = ioc.weights_section_from_params(layers, net.params)
    assert all(isinstance(v, np.ndarray) and v.dtype == np.float64
               for w in weights.values() for v in w.values())
    net.save(str(tmp_path / "native.jsn"))
    monkeypatch.setattr(ioc, "dump_doc_json", ioc.dump_doc_json_python)
    net.save(str(tmp_path / "python.jsn"))
    assert ((tmp_path / "native.jsn").read_bytes()
            == (tmp_path / "python.jsn").read_bytes())


@pytest.fixture
def fresh_runtime(tmp_path, monkeypatch):
    """The runtime as a process sees it before its first load, building
    into tmp_path/build."""
    for name, value in (("_lib", None), ("_error", None), ("_warned", False),
                        ("build_seconds", None)):
        monkeypatch.setattr(runtime, name, value)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    return tmp_path / "build"


def test_build_dir_and_hash(fresh_runtime, tmp_path, monkeypatch):
    """The library builds once into the build directory under its
    sources' hash, loads from there without building, and an edited
    source is another library."""
    runtime.load()
    path = runtime.library_path()
    assert os.path.dirname(path) == str(fresh_runtime)
    assert os.path.exists(path) and runtime.build_seconds is not None
    monkeypatch.setattr(runtime, "_lib", None)
    monkeypatch.setattr(runtime, "build_seconds", None)
    runtime.load()
    assert runtime.build_seconds is None  # loaded, not built
    src = tmp_path / "src"
    shutil.copytree(os.path.dirname(runtime.__file__), src)
    with open(src / "jsonfmt.cpp", "a") as f:
        f.write("// edited\n")
    monkeypatch.setattr(runtime, "_DIR", str(src))
    assert runtime.library_path() != path


def test_build_failure(fresh_runtime, tmp_path, capsys, monkeypatch):
    """A library that does not build: load() raises with g++'s message;
    the formatter's auto mode says so once on stderr and takes the Python
    path, with the same JSON bytes."""
    monkeypatch.setattr(runtime, "CXX_FLAGS",
                        runtime.CXX_FLAGS + ("-fno-such-option",))
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*"
                                           "fno-such-option"):
        runtime.load()
    capsys.readouterr()
    doc = _doc()
    for _ in range(2):
        assert _dump(ioc.dump_doc_json, doc) == _dump(
            ioc.dump_doc_json_python, doc)
    err = capsys.readouterr().err
    assert err.count("the native runtime is unavailable") == 1
    assert "fno-such-option" in err
    assert not runtime.available()
    assert not os.listdir(fresh_runtime)  # no library, no leftover
