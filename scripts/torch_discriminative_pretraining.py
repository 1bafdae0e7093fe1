#!/usr/bin/env python3
"""Greedy layer-wise discriminative pretraining on the PyTorch port.

scripts/discriminative_pretraining.py with each stage trained by the
port's CLI (`python -m lstm_rnn_tpu_torch.cli`, on the GPU unless the
net_config file says `device = cpu`): the same arguments and the same
stage outputs.

Rebuild of `scripts/discriminative_pretraining.pl`: starting from a network
JSON that declares the full stack, train a 1-hidden-layer net, then re-insert
the next hidden layer, delete the output layer's weights, and retrain —
repeating until all hidden layers are in place, with optional learning-rate
decay per stage.

Usage:
  torch_discriminative_pretraining.py <in_net> <net_config> <work_dir>
      <train_nc> <val_nc|-> <test_nc|-> [max_epochs] [initial_lr lr_decay]

Result: <work_dir>/trained.<n_hidden>.jsn
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys


def run_train(in_net, out_net, log_file, learning_rate, net_config,
              train_nc, val_nc, test_nc, max_epochs):
    cmd = [sys.executable, "-m", "lstm_rnn_tpu_torch.cli",
           "--train_file", train_nc]
    if val_nc:
        cmd += ["--val_file", val_nc]
    if test_nc:
        cmd += ["--test_file", test_nc]
    cmd += ["--network", in_net, "--save_network", out_net,
            "--max_epochs", str(max_epochs),
            "--autosave", "false", "--autosave_best", "false"]
    if learning_rate > 0:
        cmd += ["--learning_rate", str(learning_rate)]
    cmd += [net_config]
    print(" ".join(cmd))
    with open(log_file, "w") as log:
        log.write(" ".join(cmd) + "\n")
        log.flush()
        rv = subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT).returncode
    if rv:
        print(f"ERROR: Check {log_file}")
        sys.exit(rv)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 6:
        print(__doc__, file=sys.stderr)
        return 1
    in_net, net_config, work_dir, train_nc, val_nc, test_nc = argv[:6]
    val_nc = "" if val_nc == "-" else val_nc
    test_nc = "" if test_nc == "-" else test_nc
    max_epochs = int(argv[6]) if len(argv) > 6 else 50
    lr = float(argv[7]) if len(argv) > 7 else -1.0
    decay = float(argv[8]) if len(argv) > 8 else 1.0

    with open(in_net) as f:
        initial = json.load(f)

    # hidden layers = everything between input and [output, postoutput]
    n_hidden = len(initial["layers"]) - 3
    print(f"Found {n_hidden} hidden layers")
    hidden = [dict(l) for l in initial["layers"][1 : 1 + n_hidden]]

    net = copy.deepcopy(initial)
    del net["layers"][1 : 1 + n_hidden]
    net.pop("weights", None)
    os.makedirs(work_dir, exist_ok=True)

    out_jsn = None
    for k in range(1, n_hidden + 1):
        out_jsn = os.path.join(work_dir, f"trained.{k}.jsn")
        if not os.path.exists(out_jsn):
            layer = {"name": f"hidden_layer_{k}", "type": hidden[k - 1]["type"],
                     "size": hidden[k - 1]["size"], "bias": 1.0}
            net["layers"].insert(k, layer)
            # output layer retrains from scratch each stage; derive its
            # NAME from the topology (second-to-last layer) instead of the
            # Perl original's hardcoded-'output' assumption, which silently
            # kept stale weights for any other name
            if "weights" in net:
                out_name = net["layers"][-2]["name"]
                net["weights"].pop(out_name, None)
            jsn_file = os.path.join(work_dir, f"train.{k}.jsn")
            with open(jsn_file, "w") as f:
                json.dump(net, f, indent=1)
            log_file = os.path.join(work_dir, f"pretrain.{k}.log")
            run_train(jsn_file, out_jsn, log_file, lr, net_config,
                      train_nc, val_nc, test_nc, max_epochs)
        with open(out_jsn) as f:
            net = json.load(f)
        lr *= decay

    print(f"Done: {out_jsn}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
