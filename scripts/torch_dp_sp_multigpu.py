#!/usr/bin/env python3
"""Data parallelism composed with sequence parallelism (DP x SP), and
data-parallel streaming, across the GPUs of one host.

    python3 scripts/torch_dp_sp_multigpu.py

Runs chip_smoke.py's phase 38 alone on the first four GPUs (it needs
four), worker processes over NCCL (parallel/launch.py), with the TIMIT
net (117 -> 5 x BLSTM(250) -> softmax(183)) and the streaming stack (its
BLSTMs made LSTM(250)), random weights from a seed:

- 38a-c: the CLI's --num_devices 4 --seq_devices 2 (two ranks, each a
  2-GPU seq mesh) against --seq_devices 2 and one GPU, train (2 epochs)
  and forward; two CLI processes with the multi-host flags and
  --seq_devices 2, each seeing 2 GPUs, against it; --stream_chunk 64
  --num_devices 2 and 4 against one GPU;
- 38d-e: training frames/s of the recipe step at parallel_sequences 50,
  TIMIT f32 and bf16, on one GPU, --seq_devices 4, DP x SP 2 x 2 and
  --num_devices 4; streaming frames/s and a chunk's latency for 64
  streams on 1, 2 and 4 GPUs.

Prints the cards' names and power limits first. Exits 1 with fewer than
four GPUs. Imports torch, the port and chip_smoke.py only.
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
    n = torch.cuda.device_count()
    if n < 4:
        print(f"needs 4 GPUs; torch sees {n}", file=sys.stderr)
        return 1
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, check=True).stdout.strip()
    print(cards, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from lstm_rnn_tpu_torch.ops import _build
    _build.load()
    with tempfile.TemporaryDirectory(prefix="dp_sp_multi_") as workdir:
        cs.dp_sp_cli(torch, workdir, n)
        cs.dp_sp_rates(torch, cards.splitlines()[0], workdir, n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
