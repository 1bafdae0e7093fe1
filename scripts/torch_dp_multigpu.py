#!/usr/bin/env python3
"""Data parallelism of the port across the GPUs of one host.

    python3 scripts/torch_dp_multigpu.py [N]

Runs chip_smoke.py's phase 35 alone on the first N GPUs (default: every
GPU torch sees; at least 2), one worker process per GPU over NCCL
(parallel/launch.py), with the TIMIT net (117 -> 5 x BLSTM(250) ->
softmax(183)) and the LVCSR net (softmax(10112)), random weights from a
seed:

- 35a-c: the CLI's --num_devices 2 (and 4 with 4 GPUs) against
  --num_devices 1, train (2 epochs) and forward; two CLI processes with
  the multi-host flags, each seeing half of the GPUs, against
  --num_devices of the same total;
- 35d: training frames/s and the gradient all-reduce's time on 1, 2 and
  4 GPUs: TIMIT f32 and bf16 at parallel_sequences 50 and at 50 a GPU,
  LVCSR f32 at 50 a GPU.

Prints the cards' names and power limits and the interconnect (`nvidia-smi
topo -m`) first. Exits 1 without N GPUs. Imports torch, the port and
chip_smoke.py only.
"""

import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def main():
    import torch
    n = int(sys.argv[1]) if len(sys.argv) > 1 else torch.cuda.device_count()
    if n < 2 or torch.cuda.device_count() < n:
        print(f"needs {max(n, 2)} GPUs; torch sees "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, check=True).stdout.strip()
    print(cards, flush=True)
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True).stdout.strip()
    print(topo, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from lstm_rnn_tpu_torch.ops import _build
    _build.load()
    with tempfile.TemporaryDirectory(prefix="dp_multi_") as workdir:
        cs.dp_cli(torch, workdir, n)
        cs.dp_rates(torch, cards.splitlines()[0], workdir, n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
