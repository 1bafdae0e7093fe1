"""nc-standardize: global per-dimension standardization of a .nc dataset.

The port's copy of lstm_rnn_tpu/tools/nc_standardize.py, on the port's
data/netcdf3.py: it writes the same bytes and runs without jax.

Rebuild of `tools/nc-standardize.cpp` with the same CLI:

  nc-standardize FILE.nc -            compute mean/stdev (Welford) and
                                      standardize in place
  nc-standardize FILE.nc NORM.nc      load inputMeans/inputStdevs (and
                                      outputMeans/outputStdevs) from another
                                      nc and apply those
  nc-standardize-input ...            same but never touch targets (the
                                      reference switches on argv[0],
                                      nc-standardize.cpp:146-149; here also
                                      exposed as --input-only)

Means/stdevs are written into the file as inputMeans/inputStdevs (and
outputMeans/outputStdevs for regression targets); features are rewritten in
place. Classification files auto-skip target standardization. Stdev is the
SAMPLE standard deviation sqrt(M2/(n-1)) (nc-standardize.cpp:240-250).
"""

from __future__ import annotations

import os
import sys

import numpy as np

from lstm_rnn_tpu_torch.data.netcdf3 import NetCDF3File, write_netcdf


def welford(data: np.ndarray, chunk: int = 65536):
    """Per-column mean/stdev via chunked parallel Welford combination (Chan
    et al.) in float64 — numerically equivalent to the reference's row-wise
    Welford accumulation (nc-standardize.cpp:200-250) but vectorized: the
    old per-row Python loop took minutes on a real LVCSR corpus."""
    n_total = data.shape[0]
    mean = np.zeros(data.shape[1], np.float64)
    m2 = np.zeros(data.shape[1], np.float64)
    n = 0
    for off in range(0, n_total, chunk):
        blk = np.asarray(data[off:off + chunk], np.float64)
        bn = blk.shape[0]
        bmean = blk.mean(axis=0)
        bm2 = ((blk - bmean) ** 2).sum(axis=0)
        delta = bmean - mean
        tot = n + bn
        mean = mean + delta * (bn / tot)
        m2 = m2 + bm2 + delta * delta * (n * bn / tot)
        n = tot
    return mean.astype(np.float32), np.sqrt(m2 / (n_total - 1)).astype(np.float32)


def _rewrite(path: str, updates: dict, extra_vars: dict):
    """Rewrite a classic nc file with modified/added variables, preserving
    everything else (the reference edits in place via the netcdf API)."""
    f = NetCDF3File(path)
    dims = dict(f.dimensions)
    existing = list(f.variables)
    variables = []
    for name in existing:
        v = f.variables[name]
        if name in extra_vars:
            arr = extra_vars[name][1]
        else:
            arr = updates.get(name, f.read(name))
        variables.append((name, list(v.dim_names), arr))
    f.close()
    for name, (dim_names, arr) in extra_vars.items():
        if name not in existing:
            variables.append((name, dim_names, arr))
    write_netcdf(path + ".tmp", dims, variables)
    os.replace(path + ".tmp", path)


def main(argv=None, prog_name: str = "nc-standardize") -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    input_only = prog_name.endswith("-input")
    if "--input-only" in argv:
        argv.remove("--input-only")
        input_only = True
    if len(argv) != 2:
        print(f"Usage: {prog_name} <file.nc> <normdata.nc | - > [--input-only]",
              file=sys.stderr)
        return 1
    path, norm_src = argv

    f = NetCDF3File(path)
    input_size = f.dimensions["inputPattSize"]
    print(f"Input size: {input_size}")
    std_output = not input_only
    output_size = 1
    if "targetPattSize" in f.dimensions:
        output_size = f.dimensions["targetPattSize"]
        print(f"Output size: {output_size}")
    else:
        std_output = False
        print("WARNING: targetPattSize field not found, do not standardize "
              "outputs (classification task?)", file=sys.stderr)
    print(f"# of sequences: {f.dimensions['numSeqs']}")

    inputs = f.read("inputs")
    outputs = f.read("targetPatterns") if std_output else None
    f.close()

    if norm_src == "-":
        in_means, in_sds = welford(inputs)
        if std_output:
            out_means, out_sds = welford(outputs)
    else:
        nf = NetCDF3File(norm_src)
        print(f"Reading normdata from {norm_src}")
        in_means = nf.read("inputMeans").astype(np.float32)
        in_sds = nf.read("inputStdevs").astype(np.float32)
        if std_output:
            out_means = nf.read("outputMeans").astype(np.float32)
            out_sds = nf.read("outputStdevs").astype(np.float32)
        nf.close()

    for j in range(input_size):
        print(f"input feature #{j}: mean = {in_means[j]} +/- {in_sds[j]}")
    if std_output:
        for j in range(output_size):
            print(f"output feature #{j}: mean = {out_means[j]} +/- {out_sds[j]}")

    updates = {"inputs": ((inputs - in_means) / in_sds).astype(np.float32)}
    extra = {
        "inputMeans": (["inputPattSize"], in_means),
        "inputStdevs": (["inputPattSize"], in_sds),
    }
    if std_output:
        updates["targetPatterns"] = ((outputs - out_means) / out_sds).astype(np.float32)
        extra["outputMeans"] = (["targetPattSize"], out_means)
        extra["outputStdevs"] = (["targetPattSize"], out_sds)
    print("save normdata")
    _rewrite(path, updates, extra)
    return 0


def main_input(argv=None) -> int:
    return main(argv, prog_name="nc-standardize-input")


if __name__ == "__main__":
    sys.exit(main(prog_name=os.path.basename(sys.argv[0]) or "nc-standardize"))
