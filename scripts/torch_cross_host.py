#!/usr/bin/env python3
"""A seq or pipe mesh over several processes on the card(s), alone.

    python3 scripts/torch_cross_host.py [--one-card]

Runs chip_smoke.py's phases 45-46 after the kernel build, on the TIMIT
net (117 -> 5 x BLSTM(250) -> softmax(183)) and the LVCSR net (softmax
10,112), random weights from a seed:

- 45: two processes on cuda:0 over gloo (the messages staged through
  host memory): the hop of a TIMIT carry and a stage message bit for bit
  with its zero-cotangent control and µs a hop, and the TIMIT SP and PP
  steps against the same mesh from one process with each process's exact
  launches;
- 46 (2+ GPUs): the same over NCCL between processes of their own GPUs,
  in f32 and bf16, the LVCSR PP step, SP over 1 + 2 GPUs (3+) and over 2
  x 2 and 4 x 1 (4), each step's ms, peak MiB a GPU and busy share, the
  same steps from one process, and the CLI's multi-host --seq_devices /
  --pipeline_devices (CUDA_VISIBLE_DEVICES a process) against one
  process on as many GPUs.

With --one-card only phase 45 runs. Prints the cards' names and power
limits first. Exits 1 without a GPU. Imports torch, the port and
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
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, check=True).stdout.strip()
    print(cards, flush=True)
    card = cards.splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from lstm_rnn_tpu_torch.ops import _build
    _build.load()
    n = 1 if "--one-card" in sys.argv[1:] else torch.cuda.device_count()
    with tempfile.TemporaryDirectory(prefix="cross_host_") as workdir:
        cs.cross_host(torch, card, workdir, n)
    return 0


if __name__ == "__main__":  # the spawned workers re-import this module
    sys.exit(main())
