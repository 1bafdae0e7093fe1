#!/usr/bin/env python3
"""Sequence parallelism of the port across the GPUs of one host.

    python3 scripts/torch_sp_multigpu.py [N]

Runs chip_smoke.py's sequence-parallel phases 20 and 21 on a seq mesh of
the first N distinct GPUs (default: every GPU torch sees; at least 2),
with the TIMIT net (117 -> 5 x BLSTM(250) -> softmax(183), random weights
from a seed) and bench.py's fraction (T=500, B=50):

- 20a: one training step's loss, count and gradients against the
  single-device kernel step, with the exact launches;
- 20b: Trainer(seq_mesh=) for 2 epochs against the single-device Trainer;
- 20c: apply_seq against apply;
- 21: the CLI's --seq_devices N, train and forward, against the runs
  without it;
- 20d: training frames/s, f32 and bf16: SP on the N GPUs (profiled), SP
  on N blocks of GPU 0, and the single-device step.

Prints the cards' names and power limits first. Exits 1 without N GPUs.
Imports torch, the port and chip_smoke.py only.
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from lstm_rnn_tpu_torch.ops import _build
    from lstm_rnn_tpu_torch.parallel.mesh import make_seq_mesh
    _build.load()
    mesh = make_seq_mesh(n)
    cs.sp_step_vs_single(torch, mesh)
    with tempfile.TemporaryDirectory(prefix="sp_multi_") as workdir:
        cs.sp_trainer_epochs(torch, workdir, mesh)
        cs.sp_serving(torch, workdir, mesh)
        cs.sp_cli(torch, workdir, n)
    cs.sp_rates(torch, cards.splitlines()[0], [
        mesh, [torch.device("cuda", 0)] * n])
    return 0


if __name__ == "__main__":
    sys.exit(main())
