#!/usr/bin/env python3
"""A/B of the Trainer's data feed between two checkouts, on one CUDA GPU.

    python3 scripts/torch_ab_feed.py PARENT_DIR CHANGE_DIR [EPOCHS] [CACHES]

Each directory holds `chip_smoke.py` and its `lstm_rnn_tpu_torch/`
package (for example the parent commit unpacked with `git archive` into a
directory .gitignore lists). The checkouts run in turns, parent, change,
change, parent, each in its own process; the kernel library one of them
built is copied into the other's build directory when the sources hash
alike, so it is built once. Each trains the TIMIT recipe (f32, stochastic)
on chip_smoke.py's phase 7 corpus with length buckets (phase 39g's
Trainer, one fraction at a time) for one warm-up epoch and EPOCHS
(default 12) timed epochs (train and val passes, a synchronisation around
each), then one epoch under torch.profiler for the device's busy share.
CACHES (default "off,half") names the device cache's settings, each run
in turn: "off" (the default path: fractions assembled on the prefetch
thread) and "half", the cache on with a budget of half of the fractions'
bytes, so that every epoch misses on the fractions it did not admit,
which are assembled on the dispatching thread (the path where the
assembly is not hidden; a native miss is assembled straight into the
staging buffer). A checkout whose DataSet takes `use_native` runs
each setting twice, native and Python assembly, in alternating order.
Each line is prefixed by the run's label. Prints the card's name and power
limit first. Imports torch and the port only.
"""

import glob
import inspect
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time


def _half_budget(train, val):
    """Half of the device cache's bytes of every train and val fraction
    (float32 inputs, the targets' and pattypes' own dtypes)."""
    total = 0
    for ds in (train, val):
        for s in range(0, len(ds.sequences), ds.parallel_sequences):
            t, b, w = ds.fraction_meta(s)[1]
            total += t * b * (4 * w + (4 if ds.is_classification
                                       else 4 * ds.output_pattern_size) + 1)
    return total // 2


def worker(root, label, epochs, order, caches):
    import torch
    sys.path.insert(0, os.path.abspath(root))
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile
    from lstm_rnn_tpu_torch.data.dataset import DataSet
    from lstm_rnn_tpu_torch.models.flagship import build_timit_network
    from lstm_rnn_tpu_torch.ops import _build
    from lstm_rnn_tpu_torch.trainer import Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load()
    native_ok = "use_native" in inspect.signature(DataSet).parameters
    variants = ([True, False] if order == "0" else [False, True]) \
        if native_ok else [None]
    with tempfile.TemporaryDirectory(prefix="ab_feed_") as workdir:
        paths, _ = cs.write_train_corpus(workdir)
        train_nc, val_nc = paths["train"][0], paths["val"][0]
        for cache, native in [(c, n) for c in caches.split(",")
                              for n in variants]:
            kw = {"parallel_sequences": 50, "sort_by_length": True,
                  "bucket_lengths": True}
            if native is not None:
                kw["use_native"] = native
            train = DataSet([train_nc], trunc_seq_length=500,
                            fraction_shuffling=True, seed=cs.SEED, **kw)
            val = DataSet([val_nc], **kw)
            budget = (_half_budget(train, val) if cache == "half"
                      else None)
            tr = Trainer(build_timit_network(seed=cs.SEED), train, val,
                         learning_rate=1e-4, momentum=0.9,
                         max_epochs_no_best=10**6,
                         hybrid_online_batch=True, device="cuda",
                         device_cache=cache == "half",
                         device_cache_bytes=budget)
            tr.train_epoch()
            walls, lookups = [], []
            for _ in range(epochs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tr.train_epoch()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                st = tr.device_cache_stats()
                lookups.append((st["hits"], st["misses"]))
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                tr.train_epoch()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t1
            busy = sum(cs.dev_us(e) for e in prof.key_averages()
                       if str(getattr(e, "device_type", "")).endswith("CUDA"))
            frames = train.total_timesteps
            what = {None: "feed", True: "native", False: "python"}[native]
            print(f"{label} {what} cache={cache}: epoch s median "
                  f"{statistics.median(walls):.4f} min {min(walls):.4f} "
                  f"({frames / statistics.median(walls):,.0f} frames/s); "
                  f"each {[round(w, 4) for w in walls]}; profiled epoch "
                  f"{wall:.4f} s, device busy {busy / 1e6:.4f} s "
                  f"({100 * busy / 1e6 / wall:.1f}%); lookups hit/miss of "
                  f"the first timed epoch {lookups[0]}", flush=True)
            del tr
            torch.cuda.empty_cache()


def _share_build(a, b):
    """Copy kernel libraries (and their logs) of one checkout's build
    directory into the other's where missing: the same sources hash to
    the same name."""
    dirs = [os.path.join(r, "lstm_rnn_tpu_torch", "_build") for r in (a, b)]
    for src, dst in (dirs, dirs[::-1]):
        for path in glob.glob(os.path.join(src, "liblstm_kernels_*")):
            os.makedirs(dst, exist_ok=True)
            target = os.path.join(dst, os.path.basename(path))
            if not os.path.exists(target):
                shutil.copy2(path, target)


def main():
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2], sys.argv[3], int(sys.argv[4]), sys.argv[5],
               sys.argv[6])
        return 0
    parent, change = sys.argv[1:3]
    epochs = sys.argv[3] if len(sys.argv) > 3 else "12"
    caches = sys.argv[4] if len(sys.argv) > 4 else "off,half"
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"], check=True)
    for root, label, order in ((parent, "parent-1", "0"),
                               (change, "change-1", "0"),
                               (change, "change-2", "1"),
                               (parent, "parent-2", "1")):
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--worker", root, label, epochs, order, caches],
                       check=True)
        _share_build(parent, change)
    return 0


if __name__ == "__main__":
    sys.exit(main())
