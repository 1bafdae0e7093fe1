"""The port's data tools (lstm_rnn_tpu_torch/tools: htk2nc, nc_standardize)
against the JAX package's (lstm_rnn_tpu/tools) on the same inputs: over
the cases of tests/test_tools.py, both write the same bytes."""

import shutil
import struct

import numpy as np
import pytest

from lstm_rnn_tpu.tools import htk2nc as jax_htk2nc
from lstm_rnn_tpu.tools import nc_standardize as jax_std
from lstm_rnn_tpu_torch.data.netcdf3 import (NetCDF3File, strings_to_chars,
                                             write_netcdf)
from lstm_rnn_tpu_torch.tools import htk2nc, nc_standardize


def _htk(path, data, period=100000, kind=9):
    data = np.asarray(data, np.float32)
    with open(path, "wb") as f:
        f.write(struct.pack(">IIHH", data.shape[0], period,
                            data.shape[1] * 4, kind))
        f.write(data.astype(">f4").tobytes())


def _classification(d, rng):
    labels = [["sil", "ah", "ah", "b", "sil", "sil"], ["b", "ah", "sil", "b"]]
    lines = []
    for i, lab in enumerate(labels):
        _htk(d / f"s{i}.htk", rng.randn(len(lab), 3))
        (d / f"s{i}.txt").write_text("\n".join(lab) + "\n")
        lines.append(f"seq{i} 1 {d}/s{i}.htk {d}/s{i}.txt")
    (d / "map.txt").write_text("\n".join(lines) + "\n")
    return ["--mapping_list", str(d / "map.txt")]


def _numeric_max_len(d, rng):
    _htk(d / "a.htk", rng.randn(25, 2))
    (d / "a.labels").write_text("\n".join(str(i % 5) for i in range(25))
                                + "\n")
    (d / "map.txt").write_text(f"tagA 1 {d}/a.htk {d}/a.labels\n")
    return ["--mapping_list", str(d / "map.txt"), "--no_label_map", "5",
            "--max_len", "10"]


def _regression_concat(d, rng):
    for name, width in (("i1", 2), ("i2", 3), ("t", 4)):
        _htk(d / f"{name}.htk", rng.randn(5, width))
    (d / "map.txt").write_text(f"s 2 {d}/i1.htk {d}/i2.htk {d}/t.htk\n")
    return ["--mapping_list", str(d / "map.txt")]


def _regression_nc(path, rng, n=20, insz=3, outsz=2):
    write_netcdf(str(path), {
        "numSeqs": 2, "numTimesteps": n, "inputPattSize": insz,
        "targetPattSize": outsz, "maxSeqTagLength": 8}, [
        ("seqTags", ["numSeqs", "maxSeqTagLength"],
         strings_to_chars(["a", "b"], 8)),
        ("seqLengths", ["numSeqs"], np.asarray([n // 2, n - n // 2],
                                               np.int32)),
        ("inputs", ["numTimesteps", "inputPattSize"],
         (rng.randn(n, insz) * 3 + 5).astype(np.float32)),
        ("targetPatterns", ["numTimesteps", "targetPattSize"],
         (rng.randn(n, outsz) * 0.5 - 1).astype(np.float32)),
    ])


HTK_CASES = {"classification": _classification,
             "numeric_labels_max_len": _numeric_max_len,
             "regression_concat": _regression_concat}
# nc_standardize: (its arguments after the file, whether a norm file is
# made first by standardizing a copy in place)
STD_CASES = {"standardize": (["-"], False),
             "input_only": (["-", "--input-only"], False),
             "from_normdata": (["NORM"], True)}


@pytest.mark.parametrize("case", sorted(HTK_CASES) + sorted(STD_CASES))
def test_tools_write_the_jax_tools_bytes(tmp_path, case):
    """Each case runs in two directories laid out alike (the mapping lists
    name their own directory's files), the JAX tool in one and the port's
    in the other; the .nc files they write (htk2nc) or rewrite in place
    (nc_standardize) are the same bytes."""
    outs = {}
    for pkg, h2n, std in (("jax", jax_htk2nc, jax_std),
                          ("port", htk2nc, nc_standardize)):
        d = tmp_path / pkg
        d.mkdir()
        rng = np.random.RandomState(sorted(HTK_CASES).index(case)
                                    if case in HTK_CASES else 7)
        if case in HTK_CASES:
            args = HTK_CASES[case](d, rng) + ["--nc", str(d / "out.nc")]
            assert h2n.main(args) == 0
        else:
            extra, norm = STD_CASES[case]
            _regression_nc(d / "out.nc", rng)
            if norm:
                shutil.copy(d / "out.nc", d / "norm.nc")
                assert std.main([str(d / "norm.nc"), "-"]) == 0
                extra = [str(d / "norm.nc")]
            assert std.main([str(d / "out.nc")] + extra) == 0
        outs[pkg] = (d / "out.nc").read_bytes()
    assert outs["port"] == outs["jax"]
    f = NetCDF3File(str(tmp_path / "port" / "out.nc"))
    assert f.dimensions["numSeqs"] >= 1
    if case == "input_only":
        assert "outputMeans" not in f.variables
    if case == "standardize":
        np.testing.assert_allclose(f.read("inputs").mean(0), 0, atol=1e-5)


def test_standardize_input_entry_point(tmp_path):
    """nc-standardize-input (main_input) never touches the targets, as
    the JAX tool's entry point of that name."""
    outs = []
    for pkg, std in (("jax", jax_std), ("port", nc_standardize)):
        path = tmp_path / f"{pkg}.nc"
        _regression_nc(path, np.random.RandomState(3))
        assert std.main_input([str(path), "-"]) == 0
        outs.append(path.read_bytes())
    assert outs[0] == outs[1]
    assert "outputMeans" not in NetCDF3File(str(tmp_path
                                                / "port.nc")).variables
