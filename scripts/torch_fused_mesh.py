#!/usr/bin/env python3
"""--fuse_fractions under a data group and the one-process meshes, alone.

    python3 scripts/torch_fused_mesh.py

Runs chip_smoke.py's phase 48 on every GPU torch sees, with the TIMIT
net (117 -> 5 x BLSTM(250) -> softmax(183)), random weights from a seed,
on phase 7's corpus (200 train and 100 val sequences, bucketed):

- 48a: the CLI's training body in one NCCL rank on cuda:0, fuse 8 with
  the device cache against fuse 1 (bit for bit, launches against the
  profiler, the collectives that ran);
- 48b (2 and 4 GPUs): a data group of one GPU a rank, fuse 8 against
  fuse 1 and a rank whose graphs decline, and 20 timed epochs of each
  fuse count;
- 48c: SP on 4 blocks of cuda:0; with 2 GPUs SP over 2 and PP at 2
  stages in one process; with 4 DP x SP 2 x 2; the same checks and
  timings;
- 48d: runs started from JAX_COORDINATOR_ADDRESS and SLURM's variables
  against the flag-started ones.

Prints the cards' names and power limits and the interconnect
(`nvidia-smi topo -m`) first. Exits 1 without a GPU. Imports torch, the
port and chip_smoke.py only.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def main():
    import torch
    if not torch.cuda.is_available():
        print("needs a GPU; torch sees none", file=sys.stderr)
        return 1
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, check=True).stdout.strip()
    print(cards, flush=True)
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True).stdout.strip()
    print(topo, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} GPU(s)", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from lstm_rnn_tpu_torch.ops import _build
    _build.load()
    cs.fused_group_phase(torch, cards.splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
