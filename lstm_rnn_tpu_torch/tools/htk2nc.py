"""htk2nc: HTK feature files (+ label text / HTK target files) -> .nc dataset.

The port's copy of lstm_rnn_tpu/tools/htk2nc.py, on the port's data/netcdf3.py
and writers.read_htk: it writes the same bytes and runs without jax.

Rebuild of `tools/htk2nc.cpp` with an identical CLI (the reference source as
committed does not even compile — missing semicolons at :296/:551 — but its
intent is unambiguous):

  htk2nc --mapping_list MAP --nc OUT.nc [--no_label_map N] [--delimiter C]
         [--max_len N]

Mapping line: `<seq_tag> <#input_files> <in.htk ...> <target ...>`; input
HTK features are concatenated along the feature axis. Targets ending in
.txt/.labels switch to classification mode (one label string per line); a
label map is auto-built in SORTED label order (std::map iteration order in
the reference, htk2nc.cpp:157-180), or — the fork's LVCSR mode — labels are
numeric physical HMM-state indices used directly with a fixed class count
(htk2nc.cpp:215-243). The reference advertises `--no_label_map` but parses
`--do_label_map` (:254 vs :299); both spellings are accepted here.

`--max_len N` splits long sequences into chunks of N frames with a 5%
tolerance (pieces = ceil(max(len/N - 0.05, 1/N))), tagging chunks
`<tag>--1`, `<tag>--2`, ... (htk2nc.cpp:489-544).
"""

from __future__ import annotations

import argparse
import math
import struct
import sys
from typing import Dict, List

import numpy as np

from lstm_rnn_tpu_torch.data.netcdf3 import strings_to_chars, write_netcdf


def read_htk(path: str, header_only: bool = False):
    """Big-endian HTK file: {nSamples u32, samplePeriod u32, sampleSize u16,
    parmKind u16} + float32 frames (htk2nc.cpp:93-153). The payload reader
    is shared with writers.read_htk (one HTK parser in the codebase)."""
    if header_only:
        with open(path, "rb") as f:
            n, period, ssize, kind = struct.unpack(">IIHH", f.read(12))
        return n, ssize // 4, period, kind
    from lstm_rnn_tpu_torch.writers import read_htk as _full
    return _full(path)


def read_label_lines(path: str) -> List[str]:
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="htk2nc")
    p.add_argument("--mapping_list", required=True)
    p.add_argument("--nc", required=True)
    # reference doc says --no_label_map, reference code parses --do_label_map
    p.add_argument("--no_label_map", type=int, default=None,
                   help="don't do label mapping; use predefined number of classes")
    p.add_argument("--do_label_map", type=int, default=None,
                   help="alias of --no_label_map (the reference's actual spelling)")
    p.add_argument("--delimiter", default=" ")
    p.add_argument("--max_len", type=int, default=0)
    args = p.parse_args(argv)

    n_classes = args.no_label_map if args.no_label_map is not None else args.do_label_map
    do_label_map = n_classes is None

    # parse mapping
    seq_tags: List[str] = []
    mapping: List[List[str]] = []
    seq_lens: List[int] = []
    n_inputs = None
    vect_sizes: List[int] = []
    is_classification = False
    label_set: Dict[str, int] = {}
    input_size = 0
    output_size = 0

    with open(args.mapping_list) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                break
            tokens = [t for t in line.split(args.delimiter) if t]
            if len(tokens) < 2:
                print(f"Error: expected at least 2 filenames in file {args.mapping_list}",
                      file=sys.stderr)
                return 1
            tag = tokens[0]
            files = tokens[1:]
            n_local = int(files[0])
            files = files[1:]
            if n_local <= 0 or n_local >= len(files):
                print("Number of input HTK files (2nd column) is out of range!",
                      file=sys.stderr)
                return 1
            first = n_inputs is None
            if first:
                n_inputs = n_local
                vect_sizes = [0] * len(files)
            elif n_inputs != n_local:
                print("Inconsistent number of input htk files!", file=sys.stderr)
                return 1
            elif len(vect_sizes) != len(files):
                print(f"Expected {len(vect_sizes)} filenames!", file=sys.stderr)
                return 1

            seq_len = 0
            for fidx, fn in enumerate(files):
                if fn.endswith(".txt") or fn.endswith(".labels"):
                    if fidx == 0:
                        print("Input file must not be in text format!", file=sys.stderr)
                        return 1
                    if len(files) > 2:
                        print("Multi-task classification currently unsupported!",
                              file=sys.stderr)
                        return 1
                    is_classification = True
                    labels = read_label_lines(fn)
                    this_len = len(labels)
                    if do_label_map:
                        for lab in labels:
                            label_set.setdefault(lab, 0)
                    if first:
                        vect_sizes[fidx] = 1
                else:
                    n, comps, _, _ = read_htk(fn, header_only=True)
                    if first:
                        vect_sizes[fidx] = comps
                        if fidx >= n_inputs:
                            output_size += comps
                        else:
                            input_size += comps
                    elif vect_sizes[fidx] != comps:
                        print(f"Vector size mismatch: {comps} vs. {vect_sizes[fidx]}",
                              file=sys.stderr)
                        return 1
                    this_len = n
                if fidx > 0 and this_len != seq_len:
                    print(f"WARNING: sequence length mismatch in files: "
                          f"{this_len} vs. {seq_len}", file=sys.stderr)
                    seq_len = min(seq_len, this_len)
                elif fidx == 0:
                    seq_len = this_len
            seq_tags.append(tag)
            mapping.append(files)
            seq_lens.append(seq_len)

    total = sum(seq_lens)
    print(f"Total timesteps: {total}")
    print(f"# of sequences: {len(mapping)}")
    print(f"input size: {input_size}")

    # label list (sorted, matching std::map order) or numeric 0..N-1
    if is_classification:
        if do_label_map:
            label_list = sorted(label_set)
            label_map = {lab: i for i, lab in enumerate(label_list)}
            num_labels = len(label_list)
        else:
            num_labels = n_classes
            label_list = [str(i) for i in range(num_labels)]
            label_map = None
        print(f"Classification task #1: {num_labels} labels")
    else:
        print(f"output size: {output_size}")

    # max_len splitting (5% tolerance)
    tol = 0.05
    out_lens: List[int] = []
    out_tags: List[str] = []
    if args.max_len == 0:
        out_lens = list(seq_lens)
        out_tags = list(seq_tags)
    else:
        m = args.max_len
        for tag, L in zip(seq_tags, seq_lens):
            d = max(L / m - tol, 1.0 / m)
            pieces = math.ceil(d)
            rem = L
            for i in range(pieces - 1):
                out_lens.append(m)
                out_tags.append(f"{tag}--{i + 1}")
                rem -= m
            out_lens.append(rem)
            out_tags.append(f"{tag}--{pieces}")

    # assemble data
    all_inputs = np.zeros((total, input_size), np.float32)
    if is_classification:
        all_classes = np.zeros((total,), np.int32)
    else:
        all_outputs = np.zeros((total, output_size), np.float32)

    t = 0
    for s, files in enumerate(mapping):
        L = seq_lens[s]
        col = 0
        for fidx in range(n_inputs):
            data, _, _ = read_htk(files[fidx])
            all_inputs[t : t + L, col : col + vect_sizes[fidx]] = data[:L]
            col += vect_sizes[fidx]
        if is_classification:
            labels = read_label_lines(files[n_inputs])
            if do_label_map:
                idxs = [label_map[lab] for lab in labels[:L]]
            else:
                idxs = [int(lab) for lab in labels[:L]]
                if any(i >= n_classes for i in idxs):
                    print(f"Error reading label file {files[n_inputs]}",
                          file=sys.stderr)
                    return 1
            all_classes[t : t + L] = idxs
        else:
            col = 0
            for fidx in range(n_inputs, len(files)):
                data, _, _ = read_htk(files[fidx])
                all_outputs[t : t + L, col : col + vect_sizes[fidx]] = data[:L]
                col += vect_sizes[fidx]
        t += L

    max_tag = max(len(x) + 1 for x in out_tags)
    dims = {
        "numSeqs": len(out_lens),
        "numTimesteps": total,
        "inputPattSize": input_size,
        "maxSeqTagLength": max_tag,
    }
    variables = [
        ("seqTags", ["numSeqs", "maxSeqTagLength"], strings_to_chars(out_tags, max_tag)),
        ("seqLengths", ["numSeqs"], np.asarray(out_lens, np.int32)),
        ("inputs", ["numTimesteps", "inputPattSize"], all_inputs),
    ]
    if is_classification:
        dims["numLabels"] = num_labels
        max_lab = max(len(x) + 1 for x in label_list)
        dims["maxLabelLength"] = max_lab
        variables.insert(0, ("labels", ["numLabels", "maxLabelLength"],
                             strings_to_chars(label_list, max_lab)))
        variables.append(("targetClasses", ["numTimesteps"], all_classes))
    else:
        dims["targetPattSize"] = output_size
        variables.append(("targetPatterns", ["numTimesteps", "targetPattSize"],
                          all_outputs))
    write_netcdf(args.nc, dims, variables)
    return 0


if __name__ == "__main__":
    sys.exit(main())
