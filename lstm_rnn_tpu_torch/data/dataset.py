"""Dataset pipeline: NetCDF corpora -> padded, masked fractions.

Reproduces `currennt_lib/src/data_sets/DataSet.cpp` semantics:

- multi-file corpora with consistency checks (DataSet.cpp:499-513);
  classification detected by the `numLabels` dim (:488), `numLabels==2`
  collapses to 1 output (:493);
- fraction assembly (:300-414): `parallel_sequences` sequences padded to the
  fraction max length, patTypes FIRST/NORMAL/LAST/NONE, frame splicing
  (input_left_context/right_context with edge duplication), output_time_lag
  target shifting (default class 0 / default value 1.0 for the first lag
  frames), per-epoch input noise N(0, sigma);
- background prefetch: the next fraction is assembled on a worker thread
  while the accelerator computes (:190-223, 632-668).

- training sets: `fraction` subsetting (DataSet.cpp:516-517), sequences
  cut into pieces of `trunc_seq_length` frames (the last piece keeps at
  least half of it), sorting by length, and per-epoch fraction and
  sequence shuffling drawn from one numpy stream seeded with `seed`, in the
  JAX package's order, so one seed gives the same fraction order in both.

- fractions whose contents are the same every epoch (no input noise, no
  sequence shuffling) carry a key (`Fraction.key`: the DataSet's token and
  its sequences' ids), under which the Trainer's device cache keeps them
  on the device; `lazy_fractions` hands out each fraction's key and shape
  before assembling it, so a cache hit skips the assembly.

- the assembly runs natively (runtime/fraction.cpp, the same bytes)
  unless there is input noise, whose stream is NumPy's: `use_native`,
  with the JAX package's default. A LazyFraction can be assembled
  straight into arrays the caller owns (`assemble_into`: the Trainer's
  pinned staging buffer on a device-cache miss).

Counterpart of lstm_rnn_tpu/data/dataset.py, numpy only.

Length bucketing (off unless asked for) pads fractions up to a small set
of bucket lengths (powers-of-two progression) instead of their exact max
length, as the JAX package does to bound its compile count; the extra
padding is pure PATTYPE_NONE and numerically inert, and the LSTM kernel
stops each block at its longest row, so bucketing changes no result.
"""

from __future__ import annotations

import itertools
import os
import queue
import threading
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from lstm_rnn_tpu_torch.data.netcdf3 import NetCDF3File
from lstm_rnn_tpu_torch.ops.masking import PATTYPE_FIRST, PATTYPE_LAST, PATTYPE_NONE, PATTYPE_NORMAL


class _DiskCache:
    """Binary spill file for large corpora (mirrors the reference's cache
    file, DataSet.cpp:550-566): sequences are appended once at load and
    re-read by seek+read each epoch, so host RAM stays bounded."""

    def __init__(self, cache_dir: str = ""):
        import tempfile
        fd, self.path = tempfile.mkstemp(
            suffix=".cache", dir=cache_dir or None)
        self._f = os.fdopen(fd, "w+b")

    def put(self, arr: np.ndarray):
        arr = np.ascontiguousarray(arr)
        off = self._f.seek(0, 2)
        self._f.write(arr.tobytes())
        return (off, arr.shape, arr.dtype)

    def get(self, ref) -> np.ndarray:
        off, shape, dtype = ref
        n = int(np.prod(shape)) * np.dtype(dtype).itemsize
        self._f.seek(off)
        return np.frombuffer(self._f.read(n), dtype=dtype).reshape(shape)

    def close(self):
        if self._f:
            self._f.close()
            self._f = None
            try:
                os.remove(self.path)
            except OSError:
                pass

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


@dataclass
class SequenceRef:
    """One sequence (or a truncated piece of one) in the corpus.

    `inputs`/`targets` are ndarrays for RAM-resident corpora, or
    (offset, shape, dtype) cache references resolved via the DataSet's
    _DiskCache when the corpus is spilled to disk.
    """
    tag: str
    length: int
    inputs: object  # [length, input_size] float32 (array or cache ref)
    targets: object  # [length, target_size] float32 / [length] int32
    original_idx: int = 0  # piece index of a truncated sequence
    uid: int = -1  # corpus-wide id, stable across epochs (a cache key part)


@dataclass
class Fraction:
    """A padded mini-batch of parallel sequences (DataSetFraction.hpp)."""
    inputs: np.ndarray        # [T, B, input_size] float32
    pattypes: np.ndarray      # [T, B] int8
    targets: np.ndarray       # [T, B, out] float32 or [T, B] int32 (classes)
    seq_info: List[dict] = field(default_factory=list)  # {tag, length, originalSeqIdx}
    # the member sequences' identity when the fraction's contents are the
    # same every epoch (no input noise, no sequence shuffling); None: not
    # cacheable. The Trainer keeps keyed fractions on the device.
    key: object = None

    @property
    def shape(self):
        """The padded [T, B, input] shape (a LazyFraction's before its
        assembly)."""
        return self.inputs.shape


class LazyFraction:
    """A fraction whose key and shape are known up front and whose arrays
    are assembled at their first access: on a device-cache hit the
    Trainer never touches them, and the assembly is skipped."""

    __slots__ = ("key", "shape", "_ds", "_idx", "_real")

    def __init__(self, ds, first_idx, key, shape):
        self.key = key
        self.shape = shape
        self._ds = ds
        self._idx = first_idx
        self._real = None

    def __getattr__(self, name):
        if self._real is None:
            self._real = self._ds._make_fraction(self._idx)
        return getattr(self._real, name)

    def native_layout(self):
        """The (dtype, shape) of the fraction's inputs, targets and
        pattypes when assemble_into can write them (its DataSet assembles
        natively and they are not assembled yet), else None."""
        if self._real is not None or not self._ds._assembles_natively():
            return None
        return self._ds.host_layout(self.shape)

    def assemble_into(self, inputs, targets, pattypes) -> None:
        """Assemble the fraction natively into the caller's C-contiguous
        arrays of native_layout(). The handle keeps nothing of them: a
        later attribute access assembles its own arrays, the same
        bytes."""
        self._ds._make_fraction(self._idx, out=(inputs, targets, pattypes))


# numbers each DataSet, namespacing its fractions' keys: one Trainer's
# device cache holds the train, validation and test sets' fractions, whose
# sequence ids all start at 0
_DATASET_COUNTER = itertools.count(1)


def discard_normals(rng: np.random.RandomState, n: int,
                    chunk: int = 1 << 22) -> None:
    """Advance `rng` past n Gaussian draws, `chunk` at a time. The legacy
    Gaussian keeps its spare value from call to call, so this leaves the
    stream where any split of n normal() draws leaves it."""
    while n > 0:
        rng.standard_normal(min(chunk, n))
        n -= min(chunk, n)


def _file_rows(arrs):
    """(inputs, targets, first rows) when every (inputs, targets) pair of
    arrs is a run of rows of the same two arrays (a file held in RAM),
    at the same rows in both; else None."""
    bases = [arrs[0][j].base for j in (0, 1)]
    if not all(isinstance(b, np.ndarray) and b.flags.c_contiguous
               for b in bases):
        return None
    first = []
    for pair in arrs:
        rows = set()
        for a, base in zip(pair, bases):
            if (a.base is not base or a.shape[1:] != base.shape[1:]
                    or not a.flags.c_contiguous):
                return None
            step = base.strides[0]
            rows.add((a.__array_interface__["data"][0]
                      - base.__array_interface__["data"][0]) // step)
        if len(rows) != 1:
            return None
        first.append(rows.pop())
    return bases[0], bases[1], np.asarray(first, np.int64)


def _bucket_lengths(max_len: int) -> List[int]:
    """Bucket inventory: 16, 24, 32, 48, 64, ... up to >= max_len."""
    buckets = []
    b = 16
    while b < max_len:
        buckets.append(b)
        buckets.append(b + b // 2)
        b *= 2
    buckets.append(max(b, max_len))
    return sorted(set(x for x in buckets if x <= max(b, max_len)))


class DataSet:
    """Corpus with reference-equivalent fraction iteration.

    Sequences are held in RAM for small corpora; above
    `cache_threshold_bytes` (1 GiB) — or whenever `cache_path` is set — they
    spill to a binary disk cache and are re-read by seek per epoch, exactly
    the reference's scheme (DataSet.cpp:550-566).
    """

    CACHE_THRESHOLD_BYTES = 1 << 30

    def __init__(self, ncfiles: Sequence[str], parallel_sequences: int = 1,
                 fraction: float = 1.0, trunc_seq_length: int = 0,
                 fraction_shuffling: bool = False,
                 sequence_shuffling: bool = False,
                 noise_deviation: float = 0.0, cache_path: str = "",
                 input_left_context: int = 0, input_right_context: int = 0,
                 output_time_lag: int = 0, sort_by_length: bool = False,
                 seed: int = 0, bucket_lengths: bool = False,
                 bucket_major_shuffle: bool = True, prefetch: bool = True,
                 use_native: Optional[bool] = None):
        if not (0 < fraction <= 1):
            raise ValueError("Invalid fraction")
        self._cache_token = next(_DATASET_COUNTER)
        self.parallel_sequences = parallel_sequences
        self.fraction_shuffling = fraction_shuffling
        self.sequence_shuffling = sequence_shuffling
        self.bucket_major_shuffle = bucket_major_shuffle
        self.noise_deviation = noise_deviation
        self.left_context = input_left_context
        self.right_context = input_right_context
        self.output_time_lag = output_time_lag
        self.prefetch = prefetch
        self._rng = np.random.RandomState(seed & 0x7FFFFFFF if seed else None)
        # native assembly (runtime/fraction.cpp), the JAX package's gate:
        # None takes it without input noise (the NumPy path draws the
        # noise) when the library builds, else says why once on stderr
        # and assembles with NumPy, the same bytes; True takes it or
        # raises RuntimeError with the compiler's message
        from lstm_rnn_tpu_torch import runtime
        if use_native is None:
            use_native = noise_deviation == 0.0 and runtime.available()
        elif use_native:
            runtime.load()
        self._native = runtime if use_native else None
        # spill to a disk cache when the corpus is large or a cache path is
        # explicitly configured (cache_threshold_bytes, default 1 GiB)
        self._cache: Optional[_DiskCache] = None
        self._cache_dir = cache_path
        self.cache_threshold_bytes = self.CACHE_THRESHOLD_BYTES

        self.sequences: List[SequenceRef] = []
        self.total_sequences = 0
        self.total_timesteps = 0
        self.min_seq_length = 1 << 30
        self.max_seq_length = 0
        self.input_pattern_size = 0
        self.output_pattern_size = 0
        self.is_classification = False
        self.output_means: Optional[np.ndarray] = None
        self.output_stdevs: Optional[np.ndarray] = None
        self.has_output_standardization = False

        first = True
        for path in ncfiles:
            if not path:
                continue
            self._load_file(path, fraction, trunc_seq_length, first)
            first = False

        self.total_sequences = len(self.sequences)
        if self.output_means is None:
            self.output_means = np.zeros(self.output_pattern_size, np.float32)
            self.output_stdevs = np.ones(self.output_pattern_size, np.float32)
        if sort_by_length:
            self.sequences.sort(key=lambda s: s.length)
        for i, s in enumerate(self.sequences):
            s.uid = i
        # bucket_lengths: False = exact fraction lengths, True = power-of-2
        # inventory, "single" = ONE bucket at the corpus max (every fraction
        # the same shape), or an explicit inventory
        if bucket_lengths == "single" and self.sequences:
            self._buckets = [self.max_seq_length]
        elif isinstance(bucket_lengths, (tuple, list)) and self.sequences:
            # explicit inventory; fractions above the largest bucket pad to
            # their exact length (_padded_length falls through)
            self._buckets = sorted(int(x) for x in bucket_lengths)
        elif bucket_lengths and self.sequences:
            self._buckets = _bucket_lengths(self.max_seq_length)
        else:
            self._buckets = None

    # ----------------------------------------------------------------- loading
    def _load_file(self, path: str, fraction: float, trunc: int,
                   first: bool):
        with NetCDF3File(path) as f:
            is_cls = "numLabels" in f.dimensions
            in_size = f.dimensions["inputPattSize"]
            if is_cls:
                num_labels = f.dimensions["numLabels"]
                out_size = 1 if num_labels == 2 else num_labels
            else:
                out_size = f.dimensions["targetPattSize"]
            if first:
                self.is_classification = is_cls
                self.input_pattern_size = in_size
                self.output_pattern_size = out_size
            else:
                if is_cls != self.is_classification:
                    raise ValueError("Cannot combine classification with regression NC")
                if in_size != self.input_pattern_size:
                    raise ValueError("Number of inputs mismatch in NC files")
                if out_size != self.output_pattern_size:
                    raise ValueError("Number of outputs mismatch in NC files")

            n_seq = f.dimensions["numSeqs"]
            # max(1, ...) is the reference's subsetting floor
            # (DataSet.cpp:516-517), clamped so that an empty file loads
            # as an empty set
            n_seq = min(max(1, int(n_seq * fraction)), n_seq)
            lengths = f.read("seqLengths", 0, n_seq)
            tags = f.read_strings("seqTags")[:n_seq]

            est_bytes = 4 * f.dimensions["numTimesteps"] * (
                self.input_pattern_size + (1 if self.is_classification
                                           else self.output_pattern_size))
            if self._cache is None and (self._cache_dir
                                        or est_bytes > self.cache_threshold_bytes):
                self._cache = _DiskCache(self._cache_dir)
            tvar, tdtype = (("targetClasses", np.int32)
                            if self.is_classification else
                            ("targetPatterns", np.float32))
            # a file held in RAM is read in one piece and its sequences
            # are views of it, so that the native assembly reads a
            # fraction's frames where they lie (_file_rows)
            whole = None
            frames = int(np.sum(lengths, dtype=np.int64))
            if self._cache is None and frames:
                whole = tuple(f.read(name, 0, frames).astype(dt, copy=False)
                              for name, dt in (("inputs", np.float32),
                                               (tvar, tdtype)))

            off = 0
            for i in range(n_seq):
                remaining = int(lengths[i])
                self.total_timesteps += remaining
                k = 0
                while remaining > 0:
                    # truncation keeps a last piece of at least half of
                    # trunc frames
                    n = (min(trunc, remaining)
                         if trunc > 0 and remaining > 1.5 * trunc
                         else remaining)
                    if whole is not None:
                        xs, ts = whole[0][off:off + n], whole[1][off:off + n]
                    else:
                        xs = self._cache.put(
                            f.read("inputs", off, n).astype(np.float32))
                        ts = self._cache.put(
                            f.read(tvar, off, n).astype(tdtype))
                    self.sequences.append(SequenceRef(
                        tag=tags[i], length=n, inputs=xs, targets=ts,
                        original_idx=k))
                    self.min_seq_length = min(self.min_seq_length, n)
                    self.max_seq_length = max(self.max_seq_length, n)
                    off += n
                    remaining -= n
                    k += 1

            if first:
                if "outputMeans" in f.variables and "outputStdevs" in f.variables:
                    self.output_means = f.read("outputMeans").astype(np.float32)
                    self.output_stdevs = f.read("outputStdevs").astype(np.float32)
                    self.has_output_standardization = True

    # ------------------------------------------------------------------- misc
    @property
    def empty(self) -> bool:
        return self.total_timesteps == 0

    def num_fractions(self) -> int:
        b = self.parallel_sequences
        return (len(self.sequences) + b - 1) // b

    def _shuffle(self):
        """This epoch's fraction start indices, in emission order.
        shuffle_sequences reshuffles membership itself; shuffle_fractions
        permutes the order fractions are emitted in while keeping each
        fraction's membership, the short last one included
        (DataSet.cpp:225-248). With length buckets and bucket_major_shuffle
        the order stays random within each bucket and the buckets come out
        one after the other."""
        if self.sequence_shuffling:
            self._rng.shuffle(self.sequences)
        starts = list(range(0, len(self.sequences), self.parallel_sequences))
        if self.fraction_shuffling:
            self._rng.shuffle(starts)
            if self._buckets is not None and self.bucket_major_shuffle:
                b = self.parallel_sequences
                starts.sort(key=lambda s: self._padded_length(
                    max(q.length for q in self.sequences[s:s + b])))
        return starts

    def skip_epochs(self, n: int) -> None:
        """Draw the per-epoch shuffles of n epochs without assembling them,
        and with input noise discard each epoch's noise draws, so that a
        run restored after n epochs goes on with the fraction order and the
        noise the uninterrupted run had: an epoch draws one N(0, sigma) per
        input value of every sequence it emits (each sequence once, after
        the shuffle; _make_fraction, before frame splicing)."""
        per_epoch = (sum(s.length for s in self.sequences)
                     * self.input_pattern_size if self.noise_deviation
                     else 0)
        for _ in range(n):
            self._shuffle()
            discard_normals(self._rng, per_epoch)

    def _padded_length(self, max_len: int) -> int:
        if self._buckets is None:
            return max_len
        for b in self._buckets:
            if b >= max_len:
                return b
        return max_len

    def _seq_arrays(self, seq: SequenceRef):
        """Resolve (inputs, targets) arrays, reading from the disk cache if
        the corpus is spilled."""
        if self._cache is None or isinstance(seq.inputs, np.ndarray):
            # raw arrays: no cache, or this sequence came from an earlier
            # (small) file loaded before a LATER file's size estimate
            # created the cache — a mixed corpus holds both kinds of refs
            return seq.inputs, seq.targets
        return self._cache.get(seq.inputs), self._cache.get(seq.targets)

    # -------------------------------------------------------- fraction builder
    def _key(self, seqs):
        """The cache key of a fraction of `seqs`: None under input noise or
        sequence shuffling (the contents change every epoch)."""
        if self.noise_deviation or self.sequence_shuffling:
            return None
        return (self._cache_token,) + tuple(s.uid for s in seqs)

    def _assembles_natively(self) -> bool:
        """Whether _make_fraction takes the native path (the JAX gate,
        lstm_rnn_tpu/data/dataset.py:419)."""
        return self._native is not None and self.noise_deviation == 0.0

    def host_layout(self, shape):
        """The (dtype, shape) of the inputs, targets and pattypes of a
        fraction of padded [T, B, input] shape."""
        t_pad, b, _ = shape
        targets = ((np.dtype(np.int32), (t_pad, b))
                   if self.is_classification else
                   (np.dtype(np.float32), (t_pad, b,
                                           self.output_pattern_size)))
        return [(np.dtype(np.float32), tuple(shape)), targets,
                (np.dtype(np.int8), (t_pad, b))]

    def _assemble_native(self, seqs, t_pad: int, out):
        """(inputs, targets, pattypes) of seqs through runtime/fraction.cpp,
        into out's arrays when given: from their file's frames where they
        are views of one file held in RAM, else from a concatenation of
        their frames."""
        arrs = [self._seq_arrays(s) for s in seqs]
        lengths = np.asarray([s.length for s in seqs], np.int32)
        rows = _file_rows(arrs)
        if rows is not None:
            inputs, targets, offsets = rows
        else:
            inputs = np.concatenate([a[0] for a in arrs])
            targets = np.concatenate([a[1] for a in arrs])
            offsets = np.zeros(len(seqs), np.int64)
            np.cumsum(lengths[:-1], out=offsets[1:])
        return self._native.assemble_fraction(
            inputs, targets, offsets, lengths,
            self.is_classification, t_pad, self.parallel_sequences,
            self.input_pattern_size, self.output_pattern_size,
            self.left_context, self.right_context, self.output_time_lag,
            out=out)

    def _make_fraction(self, first_idx: int, out=None) -> Fraction:
        """The fraction of parallel_sequences sequences from first_idx;
        out=(inputs, targets, pattypes): the native path writes into
        these arrays of host_layout() and returns them."""
        b = self.parallel_sequences
        seqs = self.sequences[first_idx : first_idx + b]
        max_len = max(s.length for s in seqs)
        t_pad = self._padded_length(max_len)
        ctx_len = self.left_context + self.right_context + 1
        in_size = self.input_pattern_size * ctx_len
        lag = self.output_time_lag
        info = [{"tag": s.tag, "length": s.length,
                 "originalSeqIdx": s.original_idx} for s in seqs]
        if self._assembles_natively():
            inputs, targets, pattypes = self._assemble_native(seqs, t_pad,
                                                              out)
            return Fraction(inputs=inputs, pattypes=pattypes,
                            targets=targets, seq_info=info,
                            key=self._key(seqs))
        if out is not None:
            raise ValueError("out= takes the native assembly, which this "
                             "DataSet does not take")

        inputs = np.zeros((t_pad, b, in_size), np.float32)
        pattypes = np.full((t_pad, b), PATTYPE_NONE, np.int8)
        if self.is_classification:
            targets = np.full((t_pad, b), -1, np.int32)
        else:
            targets = np.zeros((t_pad, b, self.output_pattern_size), np.float32)

        for i, seq in enumerate(seqs):
            L = seq.length
            xs, seq_targets = self._seq_arrays(seq)
            if self.noise_deviation:
                xs = xs + self._rng.normal(
                    0.0, self.noise_deviation, xs.shape).astype(np.float32)
            if ctx_len == 1:
                inputs[:L, i, :] = xs
            else:
                # frame splicing with edge duplication (DataSet.cpp:302-364)
                cols = []
                for off in range(-self.left_context, self.right_context + 1):
                    idx = np.clip(np.arange(L) + off, 0, L - 1)
                    cols.append(xs[idx])
                inputs[:L, i, :] = np.concatenate(cols, axis=1)

            # lagged frames: t in [lag, L) reads seq_targets[t - lag]
            # (DataSet.cpp lag handling); lag >= L means EVERY frame gets
            # the default — [:L - lag] alone would wrap negatively and
            # crash the assignment for lag >= L + 2
            n_lag = max(0, L - lag)
            if self.is_classification:
                if lag > 0:
                    targets[lag:lag + n_lag, i] = seq_targets[:n_lag]
                    targets[:min(lag, L), i] = 0  # default class
                else:
                    targets[:L, i] = seq_targets
            else:
                if lag > 0:
                    targets[lag:lag + n_lag, i, :] = seq_targets[:n_lag]
                    targets[:min(lag, L), i, :] = 1.0  # default value
                else:
                    targets[:L, i, :] = seq_targets

            pattypes[1 : L - 1, i] = PATTYPE_NORMAL
            if L > 1:
                pattypes[L - 1, i] = PATTYPE_LAST
            pattypes[0, i] = PATTYPE_FIRST
        return Fraction(inputs=inputs, pattypes=pattypes, targets=targets,
                        seq_info=info, key=self._key(seqs))

    # --------------------------------------------------------------- iteration
    def fraction_meta(self, first_idx: int):
        """(cache key, padded [T, B, input] shape) of the fraction that
        starts at `first_idx`, without assembling it. B is the width the
        fraction is assembled at, parallel_sequences, also for a short
        last fraction."""
        b = self.parallel_sequences
        seqs = self.sequences[first_idx:first_idx + b]
        t_pad = self._padded_length(max(s.length for s in seqs))
        ctx = self.left_context + self.right_context + 1
        return self._key(seqs), (t_pad, b, self.input_pattern_size * ctx)

    def lazy_fractions(self):
        """One epoch of LazyFraction handles, in the order and with the
        shuffles of fractions() (no prefetch thread: a device-cache hit
        assembles nothing)."""
        for s in self._shuffle():
            key, shape = self.fraction_meta(s)
            yield LazyFraction(self, s, key, shape)

    def fractions(self):
        """One epoch of fractions; shuffles (if enabled) at epoch start and
        prefetches assembly on a background thread (DataSet.cpp:632-668)."""
        starts = self._shuffle()
        if not self.prefetch:
            for s in starts:
                yield self._make_fraction(s)
            return

        q: "queue.Queue" = queue.Queue(maxsize=2)

        def worker():
            try:
                for s in starts:
                    q.put(("ok", self._make_fraction(s)))
            except Exception as e:  # pragma: no cover
                q.put(("err", e))
            q.put(("done", None))

        th = threading.Thread(target=worker, daemon=True)
        th.start()
        while True:
            kind, val = q.get()
            if kind == "done":
                break
            if kind == "err":
                raise val
            yield val
        th.join()
