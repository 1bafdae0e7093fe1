"""The data-group worker of tests/test_torch_fused.py: trains the port's
Trainer(data_group=) on its rank's blocks with each fuse count asked for
and saves what the test compares. parallel/launch.py spawns it, and a
spawned worker imports the module that holds its function: this one
imports no JAX package."""

import contextlib
import io
import os

import numpy as np
import torch


def train_rows(t, stats=None):
    """Train to the end: each epoch's (training error, class error,
    validation error, class error), and the parameters as numpy."""
    rows = []
    done = False
    while not done:
        done = t.train_epoch()
        rows.append((t.cur_training_error, t.cur_training_class_error,
                     t.cur_validation_error, t.cur_validation_class_error))
        if stats is not None:
            stats.append(t.device_cache_stats())
    params = {n: {k: np.asarray(v) for k, v in layer.items()}
              for n, layer in t.exact_params().items()}
    return rows, params


def train_worker(group, out_dir, layers, weights, files, ds_kw, epochs,
                 runs):
    """For each (name, Trainer keywords) of `runs`: a Trainer on this rank
    of `group` from the numpy `weights`, trained for `epochs` epochs over
    files (train, validation or None); saves its rows, parameters, cache
    lookups, the stacked entries' rows (by set, "train" or "val", and
    the fraction's sequence ids) and the lines it printed to
    out_dir/<name>_rank<r>.pt."""
    from lstm_rnn_tpu_torch.data.dataset import DataSet
    from lstm_rnn_tpu_torch.network import Network
    from lstm_rnn_tpu_torch.trainer import Trainer
    for name, kw in runs:
        net = Network(layers)
        net.params = {n: {k: np.array(v) for k, v in layer.items()}
                      for n, layer in weights.items()}
        t = Trainer(net, DataSet([files[0]], **ds_kw),
                    DataSet([files[1]], **ds_kw) if files[1] else None,
                    learning_rate=1e-3, momentum=0.9, max_epochs=epochs,
                    hybrid_online_batch=True, device="cpu",
                    data_group=group, **kw)
        stats = []
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rows, params = train_rows(t, stats)
        sets = {ds._cache_token: which for which, ds in (
            ("train", t.train_set), ("val", t.validation_set))
            if ds is not None}
        stacked = {sets[token]: {key[1:]: [a.numpy() for a in batch]
                                 for key, batch in entry["rows"].items()}
                   for token, entry in t._stacked.items()}
        torch.save({"rows": rows, "params": params, "stats": stats,
                    "stacked": stacked, "out": buf.getvalue()},
                   os.path.join(out_dir, f"{name}_rank{group.rank}.pt"))
