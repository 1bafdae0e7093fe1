#!/usr/bin/env python3
"""A/B of the Trainer's data feed between two checkouts, on one CUDA GPU.

    python3 scripts/torch_ab_feed.py PARENT_DIR CHANGE_DIR [EPOCHS]

Each directory holds `chip_smoke.py` and its `lstm_rnn_tpu_torch/`
package (for example the parent commit unpacked with `git archive` into a
directory .gitignore lists). The checkouts run in turns, parent, change,
change, parent, each in its own process; the kernel library one of them
built is copied into the other's build directory when the sources hash
alike, so it is built once. Each trains the TIMIT recipe (f32, stochastic)
on chip_smoke.py's phase 7 corpus with length buckets (phase 39g's
Trainer, the cache off, one fraction at a time: the default path) for one
warm-up epoch and EPOCHS (default 12) timed epochs (train and val passes,
a synchronisation around each), then one epoch under torch.profiler for
the device's busy share. A checkout whose DataSet takes `use_native` runs
it twice, native and Python assembly, in alternating order. Each line is
prefixed by the run's label. Prints the card's name and power limit
first. Imports torch and the port only.
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


def worker(root, label, epochs, order):
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
        for native in variants:
            kw = {"parallel_sequences": 50, "sort_by_length": True,
                  "bucket_lengths": True}
            if native is not None:
                kw["use_native"] = native
            train = DataSet([train_nc], trunc_seq_length=500,
                            fraction_shuffling=True, seed=cs.SEED, **kw)
            val = DataSet([val_nc], **kw)
            tr = Trainer(build_timit_network(seed=cs.SEED), train, val,
                         learning_rate=1e-4, momentum=0.9,
                         max_epochs_no_best=10**6,
                         hybrid_online_batch=True, device="cuda")
            tr.train_epoch()
            walls = []
            for _ in range(epochs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tr.train_epoch()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
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
            print(f"{label} {what}: epoch s median "
                  f"{statistics.median(walls):.4f} min {min(walls):.4f} "
                  f"({frames / statistics.median(walls):,.0f} frames/s); "
                  f"each {[round(w, 4) for w in walls]}; profiled epoch "
                  f"{wall:.4f} s, device busy {busy / 1e6:.4f} s "
                  f"({100 * busy / 1e6 / wall:.1f}%)", flush=True)
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
        worker(sys.argv[2], sys.argv[3], int(sys.argv[4]), sys.argv[5])
        return 0
    parent, change = sys.argv[1:3]
    epochs = sys.argv[3] if len(sys.argv) > 3 else "12"
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"], check=True)
    for root, label, order in ((parent, "parent-1", "0"),
                               (change, "change-1", "0"),
                               (change, "change-2", "1"),
                               (parent, "parent-2", "1")):
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--worker", root, label, epochs, order], check=True)
        _share_build(parent, change)
    return 0


if __name__ == "__main__":
    sys.exit(main())
