"""Forward-pass output writers: single_csv, per-sequence csv, HTK binary.

Reproduces `currennt/src/main.cpp:307-490`: the forward-pass mode runs the
network over the feed-forward dataset and writes the output layer's
activations per sequence, applying `output_time_lag` shifting (frames are
read `lag` steps ahead; the final `lag` frames repeat the last frame) and
optional de-standardization (`revert_std`: v*stdev + mean from the nc file's
outputMeans/outputStdevs).

HTK format: 12-byte big-endian header {nSamples u32, samplePeriod u32 =
feature_period*1e4, sampleSize u16 = nComps*4, parmKind u16} followed by
big-endian float32 samples (main.cpp:416-486).
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional

import numpy as np


def _shift_unstandardize(seq_out: np.ndarray, lag: int,
                         means: Optional[np.ndarray],
                         stdevs: Optional[np.ndarray]) -> np.ndarray:
    """seq_out: [L, n]. Applies output_time_lag shift + de-standardization."""
    L = seq_out.shape[0]
    if lag > 0:
        idx = np.minimum(np.arange(L) + lag, L - 1)
        seq_out = seq_out[idx]
    if means is not None:
        seq_out = seq_out * stdevs + means
    return seq_out


def write_single_csv(path: str, tags: List[str], outputs: List[np.ndarray],
                     lag: int = 0, means=None, stdevs=None, append: bool = False):
    """One line per sequence: `tag;v;v;...` (main.cpp:321-366)."""
    mode = "a" if append else "w"
    with open(path, mode) as f:
        for tag, out in zip(tags, outputs):
            out = _shift_unstandardize(out, lag, means, stdevs)
            f.write(tag)
            for row in out:
                for v in row:
                    f.write(";" + repr(float(np.float32(v))))
            f.write("\n")


def write_csv(outdir: str, tags: List[str], outputs: List[np.ndarray],
              lag: int = 0, means=None, stdevs=None):
    """One `<tag>.csv` per sequence, directories created from the tag's
    relative path (main.cpp:368-414)."""
    for tag, out in zip(tags, outputs):
        out = _shift_unstandardize(out, lag, means, stdevs)
        base, _ = os.path.splitext(tag)
        rel = os.path.relpath(base + ".csv", "/") if os.path.isabs(base) else base + ".csv"
        path = os.path.join(outdir, rel)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            for row in out:
                f.write(";".join(repr(float(np.float32(v))) for v in row))
                f.write("\n")


def write_htk(outdir: str, tags: List[str], outputs: List[np.ndarray],
              lag: int = 0, means=None, stdevs=None,
              feature_period: float = 10.0, kind: int = 9):
    """One `<tag>.htk` per sequence, big-endian HTK binary (main.cpp:416-486)."""
    for tag, out in zip(tags, outputs):
        if out.shape[0] == 0:
            continue
        out = _shift_unstandardize(out, lag, means, stdevs).astype(np.float32)
        rel = tag + ".htk"
        rel = os.path.relpath(rel, "/") if os.path.isabs(rel) else rel
        path = os.path.join(outdir, rel)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        n, comps = out.shape
        with open(path, "wb") as f:
            f.write(struct.pack(">IIHH", n, int(feature_period * 1e4),
                                comps * 4, kind))
            f.write(out.astype(">f4").tobytes())


def read_htk(path: str):
    """Read an HTK file back (for tools/tests)."""
    with open(path, "rb") as f:
        n, period, ssize, kind = struct.unpack(">IIHH", f.read(12))
        comps = ssize // 4
        data = np.frombuffer(f.read(n * comps * 4), dtype=">f4").reshape(n, comps)
    return data.astype(np.float32), period, kind
