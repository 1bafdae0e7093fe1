#!/usr/bin/env python3
"""Generate synthetic .nc datasets so every example recipe is runnable.

make_example_data.py on the PyTorch port's NetCDF writer
(lstm_rnn_tpu_torch/data/netcdf3.py), so that it runs where jax is not
installed: the same arguments, the same never-clobber rule and, for the
same arguments, the same bytes. The recipes' run_torch.sh call it.

The reference ships only `speech_recognition_chime/val_1_speaker.nc` (its
train blobs were stripped, `.MISSING_LARGE_BLOBS`), so its examples cannot
run either. This generator produces shape-compatible synthetic corpora for
every recipe: features are class-conditional Gaussians over a slowly
switching state sequence, so training visibly reduces the error — the
recipes exercise the real pipeline end to end without distributing corpora.

Usage:
  python examples/make_example_data_torch.py [recipe ...] [--seqs N] [--len-scale F]

Recipes: chime_recognition, chime_autoencoding, timit, lvcsr (default:
all).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from lstm_rnn_tpu_torch.data.netcdf3 import strings_to_chars, write_netcdf  # noqa: E402


def _state_sequence(rng, length, n_classes, hold=8, pool=None):
    """Slowly switching class sequence (HMM-state-like persistence).

    pool: optional array of allowed class ids — LVCSR corpora visit only
    a subset of the physical-state inventory (exactly what htk2nc's
    numeric-state mode produces: labels index a FIXED inventory larger
    than any one corpus's visited set)."""
    states = np.empty(length, np.int32)
    t = 0

    def draw():
        if pool is not None:
            return int(pool[rng.randint(pool.size)])
        return rng.randint(n_classes)

    cur = draw()
    while t < length:
        dur = max(1, int(rng.poisson(hold)))
        states[t:t + dur] = cur
        t += dur
        cur = draw()
    return states


def _skip_existing(path, overwrite):
    """Never clobber a file the user already has: the run.sh hooks call
    this generator when ANY file of a recipe pair is missing, and the
    present one may be REAL data (htk2nc output, or the reference's
    shipped val_1_speaker.nc) — only the missing file is generated."""
    if os.path.exists(path) and not overwrite:
        print(f"{path} exists — left untouched (pass --overwrite to "
              "regenerate)")
        return True
    return False


def _make_classification_nc(path, rng, n_seqs, len_range, in_size, n_classes,
                            means=None, pool=None, overwrite=False):
    if _skip_existing(path, overwrite):
        return
    lengths = rng.randint(len_range[0], len_range[1] + 1, n_seqs)
    total = int(lengths.sum())
    # class-conditional means (shared between train/val so validation
    # measures the same task)
    if means is None:
        means = rng.randn(n_classes, in_size).astype(np.float32) * 0.8
    inputs = np.empty((total, in_size), np.float32)
    classes = np.empty(total, np.int32)
    pos = 0
    for L in lengths:
        st = _state_sequence(rng, int(L), n_classes, pool=pool)
        classes[pos:pos + L] = st
        inputs[pos:pos + L] = means[st] + rng.randn(int(L), in_size).astype(np.float32)
        pos += L
    tags = [f"synthetic_{i:04d}" for i in range(n_seqs)]
    write_netcdf(path, {
        "numSeqs": n_seqs, "numTimesteps": total, "inputPattSize": in_size,
        "numLabels": n_classes, "maxSeqTagLength": 24,
    }, [
        ("seqTags", ["numSeqs", "maxSeqTagLength"], strings_to_chars(tags, 24)),
        ("seqLengths", ["numSeqs"], lengths.astype(np.int32)),
        ("inputs", ["numTimesteps", "inputPattSize"], inputs),
        ("targetClasses", ["numTimesteps"], classes),
    ])
    print(f"wrote {path}: {n_seqs} seqs, {total} frames, "
          f"{in_size}-dim, {n_classes} classes")


def _make_regression_nc(path, rng, n_seqs, len_range, size, overwrite=False):
    """Autoencoding: targets = clean signal, inputs = noisy version."""
    if _skip_existing(path, overwrite):
        return
    lengths = rng.randint(len_range[0], len_range[1] + 1, n_seqs)
    total = int(lengths.sum())
    targets = np.empty((total, size), np.float32)
    pos = 0
    for L in lengths:
        t = np.linspace(0, 4 * np.pi, int(L))[:, None]
        phase = rng.rand(1, size) * 2 * np.pi
        freq = 1 + rng.rand(1, size) * 2
        targets[pos:pos + L] = np.sin(freq * t + phase).astype(np.float32)
        pos += L
    inputs = targets + rng.randn(total, size).astype(np.float32) * 0.3
    tags = [f"synthetic_{i:04d}" for i in range(n_seqs)]
    write_netcdf(path, {
        "numSeqs": n_seqs, "numTimesteps": total, "inputPattSize": size,
        "targetPattSize": size, "maxSeqTagLength": 24,
    }, [
        ("seqTags", ["numSeqs", "maxSeqTagLength"], strings_to_chars(tags, 24)),
        ("seqLengths", ["numSeqs"], lengths.astype(np.int32)),
        ("inputs", ["numTimesteps", "inputPattSize"], inputs),
        ("targetPatterns", ["numTimesteps", "targetPattSize"], targets),
    ])
    print(f"wrote {path}: {n_seqs} seqs, {total} frames, {size}-dim regression")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("recipes", nargs="*",
                   help="recipes to generate: chime_recognition, "
                        "chime_autoencoding, timit, lvcsr (default: all)")
    p.add_argument("--seqs", type=int, default=60,
                   help="training sequences per corpus (val gets ~1/4)")
    p.add_argument("--len-scale", type=float, default=1.0,
                   help="sequence-length multiplier (1.0 = 80..200 frames; "
                        "the TIMIT flagship bench uses ~4.0 for 300..800)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--overwrite", action="store_true",
                   help="regenerate files that already exist (default: "
                        "existing files — possibly real data — are kept)")
    p.add_argument("--out-root", default=HERE)
    args = p.parse_args(argv)
    known = ["chime_recognition", "chime_autoencoding", "timit", "lvcsr"]
    for r in args.recipes:
        if r not in known:
            p.error(f"unknown recipe '{r}' (choose from {', '.join(known)})")
    recipes = args.recipes or known
    rng = np.random.RandomState(args.seed)
    lo, hi = int(80 * args.len_scale), int(200 * args.len_scale)
    n_val = max(2, args.seqs // 4)

    if "chime_recognition" in recipes:
        d = os.path.join(args.out_root, "speech_recognition_chime")
        means = rng.randn(51, 39).astype(np.float32) * 0.8
        _make_classification_nc(os.path.join(d, "train_1_speaker.nc"),
                                rng, args.seqs, (lo, hi), 39, 51, means,
                                overwrite=args.overwrite)
        _make_classification_nc(os.path.join(d, "val_1_speaker.nc"),
                                rng, n_val, (lo, hi), 39, 51, means,
                                overwrite=args.overwrite)
    if "chime_autoencoding" in recipes:
        d = os.path.join(args.out_root, "speech_autoencoding_chime")
        _make_regression_nc(os.path.join(d, "train_1_speaker.nc"),
                            rng, args.seqs, (lo, hi), 39,
                            overwrite=args.overwrite)
        _make_regression_nc(os.path.join(d, "val_1_speaker.nc"),
                            rng, n_val, (lo, hi), 39,
                            overwrite=args.overwrite)
    if "timit" in recipes:
        d = os.path.join(args.out_root, "alignments")
        os.makedirs(d, exist_ok=True)
        means = rng.randn(183, 117).astype(np.float32) * 0.8
        _make_classification_nc(os.path.join(d, "timit_trainD117.nc"),
                                rng, args.seqs, (lo, hi), 117, 183, means,
                                overwrite=args.overwrite)
        _make_classification_nc(os.path.join(d, "timit_cvD117.nc"),
                                rng, n_val, (lo, hi), 117, 183, means,
                                overwrite=args.overwrite)
    if "lvcsr" in recipes:
        # the fork's physical-HMM-state target (htk2nc --no_label_map
        # --num_labels 10112): labels index a fixed ~10k-state inventory;
        # any one corpus visits a subset of it
        d = os.path.join(args.out_root, "alignments")
        os.makedirs(d, exist_ok=True)
        n_states = 10112
        means = (rng.randn(n_states, 117) * 0.8).astype(np.float32)
        pool = rng.choice(n_states, size=512, replace=False)
        _make_classification_nc(os.path.join(d, "lvcsr_train_states.nc"),
                                rng, args.seqs, (lo, hi), 117, n_states,
                                means, pool=pool,
                                overwrite=args.overwrite)
        _make_classification_nc(os.path.join(d, "lvcsr_cv_states.nc"),
                                rng, n_val, (lo, hi), 117, n_states,
                                means, pool=pool,
                                overwrite=args.overwrite)
    return 0


if __name__ == "__main__":
    sys.exit(main())
