#!/usr/bin/env python3
"""Epoch rates of the Trainer's fused passes (--fuse_fractions, the step
graphs of lstm_rnn_tpu_torch/graphs.py) on one CUDA GPU.

    python3 scripts/torch_fused_rates.py [EPOCHS]

Runs from the root of a checkout (it imports chip_smoke.py's helpers),
each configuration below in a process of its own. On chip_smoke.py's
phase 7 corpus (5 training and 2 validation fractions in length
buckets), for each configuration of phase 47 (TIMIT f32 and bf16, the
remat K=4 TIMIT step, LVCSR f32) and the device cache off and on, trains
--fuse_fractions 1 and 8 in the order 1, 8, 8, 1, each run a fresh
Trainer: two epochs that warm up and capture, EPOCHS (default 20) timed
epochs, each synchronised, and a profiled epoch for the device's busy
share (where that profile holds no device event, as the LVCSR runs' have
after 22 epochs on an H100, it says so). Prints each run's median,
lowest and highest epoch wall, and for each pair of fuse counts the
ratio of their medians; a gain stands only where the slowest fused epoch
is faster than the fastest unfused one.

Then the 8-shape LVCSR case: 400 training and 400 validation sequences
at 8 lengths (143-500 frames), exact fraction lengths, so that a pass is
8 fractions of 8 shapes and the fused run holds 16 graphs (8 shapes, both
modes) beside the stacked epochs, at 10,112 labels in f32. Two epochs at
--fuse_fractions 8 with the device cache on against --fuse_fractions 1:
the epoch errors and weights, the captures, eager steps, the pools' and
the cache's bytes against the cache's budget, and the card's peak
allocation.

Prints the card's name and power limit first; writes every number to
chiprun_out/fused_rates.json as well. Imports torch and the port only.
"""

import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def summary(walls):
    return {"median": statistics.median(walls), "min": min(walls),
            "max": max(walls)}


def rates(torch, cs, corpora, epochs, config):
    out = []
    for recipe, dtype, remat in [cs.GRAPH_RUNS[config]]:
        name = f"{recipe} {'f32' if dtype == 'float32' else 'bf16'}"
        for cache in (False, True):
            walls = {1: [], 8: []}
            for fuse in (1, 8, 8, 1):
                tr = cs._fused_trainer(
                    *corpora["LVCSR" if recipe == "LVCSR" else "TIMIT"],
                    recipe, dtype, remat, fuse, cache)
                steps = (tr.train_set.num_fractions()
                         + tr.validation_set.num_fractions())
                first, timed, (pwall, busy, _) = cs.fused_epochs(
                    torch, tr, epochs)
                st = tr.graph_stats.as_dict()
                s = summary(timed)
                walls[fuse] += timed
                row = {"config": name, "cache": cache, "fuse": fuse,
                       "first": first, "epochs": timed, **s,
                       "step_ms": 1e3 * s["median"] / steps,
                       "busy": busy / pwall if busy else None,
                       "captures": st["captures"],
                       "capture_s": st["capture_seconds"],
                       "pool_mib": sum(st["pool_bytes"]) / 2**20}
                out.append(row)
                print(f"{name} cache={'on' if cache else 'off'} fuse={fuse}:"
                      f" epochs 1-2 {first[0]:.4f}, {first[1]:.4f} s; "
                      f"{epochs} epochs median {s['median']:.4f} s (min "
                      f"{s['min']:.4f}, max {s['max']:.4f}), "
                      f"{row['step_ms']:.2f} ms a step ({steps} steps); "
                      + (f"busy {100 * busy / pwall:.1f}% of a profiled "
                         "epoch;" if busy else "the profiled epoch recorded "
                         "no device event;") +
                      f" captures {st['captures']} "
                      f"{[round(x, 4) for x in st['capture_seconds']]} s, "
                      f"pools {row['pool_mib']:.1f} MiB", flush=True)
                tr.drop_graphs()
                del tr
                torch.cuda.empty_cache()
            one, eight = summary(walls[1]), summary(walls[8])
            stands = eight["max"] < one["min"]
            print(f"{name} cache={'on' if cache else 'off'}: fuse 1 median "
                  f"{one['median']:.4f} s ({one['min']:.4f}-{one['max']:.4f}"
                  f"), fuse 8 {eight['median']:.4f} s ({eight['min']:.4f}-"
                  f"{eight['max']:.4f}) over {len(walls[1])} epochs each: "
                  f"ratio {one['median'] / eight['median']:.3f}; "
                  + ("a gain: the slowest fused epoch beats the fastest "
                     "unfused one" if stands else
                     "no gain above the spread"), flush=True)
    return out


def eight_shapes(torch, cs, workdir):
    """The 8-shape LVCSR case (see the module docstring)."""
    from lstm_rnn_tpu_torch.data.dataset import DataSet
    from lstm_rnn_tpu_torch.data.netcdf3 import strings_to_chars, write_netcdf
    from lstm_rnn_tpu_torch.models.flagship import build_lvcsr_network
    from lstm_rnn_tpu_torch.trainer import Trainer
    rng = np.random.RandomState(cs.SEED + 7)
    paths = []
    for name in ("train", "val"):
        lengths = rng.permutation(np.repeat(
            [143, 201, 257, 311, 367, 419, 461, 500], 50)).astype(np.int32)
        n, total = len(lengths), int(lengths.sum())
        path = os.path.join(workdir, f"lvcsr8_{name}.nc")
        write_netcdf(path, {"numSeqs": n, "numTimesteps": total,
                            "inputPattSize": 117, "numLabels": cs.S_LVCSR,
                            "maxSeqTagLength": 24}, [
            ("seqTags", ["numSeqs", "maxSeqTagLength"],
             strings_to_chars([f"{name}{i:04d}" for i in range(n)], 24)),
            ("seqLengths", ["numSeqs"], lengths),
            ("inputs", ["numTimesteps", "inputPattSize"],
             rng.randn(total, 117).astype(np.float32)),
            ("targetClasses", ["numTimesteps"],
             rng.randint(0, cs.S_LVCSR, total).astype(np.int32))])
        paths.append(path)
    res = {}
    for fuse in (1, 8):
        kw = {"parallel_sequences": 50, "sort_by_length": True}
        tr = Trainer(build_lvcsr_network(seed=cs.SEED),
                     DataSet([paths[0]], fraction_shuffling=True,
                             seed=cs.SEED, **kw),
                     DataSet([paths[1]], **kw), learning_rate=1e-4,
                     momentum=0.9, hybrid_online_batch=True, device="cuda",
                     fuse_fractions=fuse, device_cache=True)
        shapes = {tuple(f.shape) for f in tr.train_set.lazy_fractions()}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rows = []
        for _ in range(2):
            tr.train_epoch()
            rows.append((tr.cur_training_error, tr.cur_training_class_error,
                         tr.cur_validation_error,
                         tr.cur_validation_class_error))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = tr.graph_stats.as_dict()
        pools = sum(g.pool_bytes for g in tr._graphs.values())
        res[fuse] = dict(
            rows=rows, wall=wall, shapes=len(shapes),
            warmups=st["warmups"], captures=st["captures"],
            replays=st["replays"], eager=st["eager"],
            pool_gib=pools / 2**30, cache_gib=tr._dev_cache_bytes / 2**30,
            budget_gib=tr._dev_cache_budget / 2**30,
            room_gib=tr._cache_room() / 2**30,
            stacked=len(tr._stacked),
            peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            reserved_gib=torch.cuda.memory_reserved() / 2**30,
            params={n: {k: v.detach().float().cpu().numpy()
                        for k, v in layer.items()}
                    for n, layer in tr.params.items()})
        print(f"LVCSR f32, 8 shapes ({len(shapes)} training shapes), fuse "
              f"{fuse}, the cache on: 2 epochs {wall:.2f} s; rows {rows}; "
              f"warm-ups {st['warmups']}, captures {st['captures']}, "
              f"replays {st['replays']}, eager {st['eager']}; pools "
              f"{res[fuse]['pool_gib']:.2f} GiB, the cache "
              f"{res[fuse]['cache_gib']:.3f} GiB in {len(tr._stacked)} "
              f"stacked entries, budget {res[fuse]['budget_gib']:.2f} GiB, "
              f"room left {res[fuse]['room_gib']:.2f} GiB; peak allocated "
              f"{res[fuse]['peak_gib']:.2f} GiB, reserved "
              f"{res[fuse]['reserved_gib']:.2f} GiB", flush=True)
        tr.drop_graphs()
        del tr
        torch.cuda.empty_cache()
    a, b = res[8].pop("params"), res[1].pop("params")
    rel = max(float(np.abs(a[n][k] - b[n][k]).max()
                    / max(np.abs(b[n][k]).max(), 1e-30))
              for n in b for k in b[n])
    rows_rel = max(abs(x - y) / max(abs(y), 1e-30)
                   for r8, r1 in zip(res[8]["rows"], res[1]["rows"])
                   for x, y in zip(r8, r1))
    print(f"LVCSR f32, 8 shapes: fuse 8 against fuse 1: weights rel "
          f"{rel:.2e}, epoch rows rel {rows_rel:.2e}", flush=True)
    res["weights_rel"], res["rows_rel"] = rel, rows_rel
    return res


def part(torch, cs, epochs, which, workdir):
    """One process's share: configuration `which` of chip_smoke's
    GRAPH_RUNS on the corpora in workdir, or the 8-shape case."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if which == "8shapes":
        return eight_shapes(torch, cs, workdir)
    corpora = {r: (os.path.join(workdir, f"{r}_train.nc"),
                   os.path.join(workdir, f"{r}_val.nc"))
               for r in ("TIMIT", "LVCSR")}
    return rates(torch, cs, corpora, epochs, int(which))


def main():
    import subprocess
    import torch
    if not torch.cuda.is_available():
        print("torch sees no CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    epochs = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    if len(sys.argv) > 2:  # a share, run by the parent process below
        which, workdir, out = sys.argv[2:5]
        with open(out, "w") as f:
            json.dump(part(torch, cs, epochs, which, workdir), f)
        return 0
    from lstm_rnn_tpu_torch.ops import _build
    card = cs.card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.load()
    print(f"kernel library ready in {time.perf_counter() - t0:.1f} s",
          flush=True)
    doc = {"card": card, "epochs": epochs, "rates": []}
    with tempfile.TemporaryDirectory(prefix="fused_rates_") as workdir:
        cs.graph_corpora(workdir)
        for which in [str(i) for i in range(len(cs.GRAPH_RUNS))] + [
                "8shapes"]:
            out = os.path.join(workdir, f"part_{which}.json")
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            str(epochs), which, workdir, out], check=True)
            with open(out) as f:
                res = json.load(f)
            if which == "8shapes":
                doc["eight_shapes"] = res
            else:
                doc["rates"] += res
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "fused_rates.json"),
              "w") as f:
        json.dump(doc, f, indent=1)
    print(f"took {time.perf_counter() - t0:.0f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
