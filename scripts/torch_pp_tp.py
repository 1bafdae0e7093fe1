#!/usr/bin/env python3
"""Pipeline and tensor parallelism on the card(s), alone.

    python3 scripts/torch_pp_tp.py [--distinct]

Runs chip_smoke.py's phases 42-44 after the kernel build, on the TIMIT
net (117 -> 5 x BLSTM(250) -> softmax(183)), the LVCSR net (softmax
10,112) and the CHiME autoencoding net (39 -> BLSTM 156 / 256 / 156 ->
39), random weights from a seed:

- 42: pipelined TIMIT and LVCSR steps on a pipe mesh of cuda:0 against
  one GPU (f32, bf16) with exact launches and failing controls,
  apply_pipelined against apply, step ms and peak memory, a profile;
- 43: tensor-parallel TIMIT (5 shards) and CHiME autoencoding (2 shards)
  steps on a model mesh of cuda:0 against one GPU, the bf16 mode's f32
  TP layers, times and a profile;
- 44: with 2+ GPUs the CLI's --pipeline_devices 2 and --model_devices 2
  (and DP x PP, DP x TP with 4) against one GPU, and the steps on
  distinct GPUs with each GPU's peak memory; on one GPU the CLI's
  refusals.

With --distinct only phase 44 runs (it needs 2 GPUs, DP x PP and DP x
TP 4; on a host of four: `python3 scripts/torch_pp_tp.py --distinct`).
Prints the cards' names and power limits first. Exits 1 without a GPU.
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
    n = torch.cuda.device_count()
    distinct = "--distinct" in sys.argv[1:]
    if distinct and n < 2:
        print(f"--distinct needs 2 GPUs; torch sees {n}", file=sys.stderr)
        return 1
    if not distinct:
        cs.pp_steps(torch, card)
        cs.pp_rates(torch, card)
    with tempfile.TemporaryDirectory(prefix="pp_tp_") as workdir:
        if not distinct:
            cs.pp_serving(torch, workdir)
            cs.tp_steps(torch, card)
        if n >= 2:
            cs.pp_tp_cli(torch, workdir, n)
            cs.pp_tp_distinct(torch, card, n)
        else:
            cs.pp_tp_refused_on_one_gpu(torch, workdir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
