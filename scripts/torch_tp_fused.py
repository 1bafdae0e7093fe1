#!/usr/bin/env python3
"""Tensor parallelism on K8 and the fused passes under TP and across
processes, on the card(s), alone.

    python3 scripts/torch_tp_fused.py [--distinct]

Runs, after the kernel build, chip_smoke.py's
- phase 43: K8f and K8b against their twins at a TIMIT layer (5 shards of
  cuda:0), the tensor-parallel TIMIT (5 shards) and CHiME autoencoding
  (2 shards) steps on a model mesh of cuda:0 against one GPU with their
  exact launches, their ms and a profile, the bf16 mode's f32 TP layers;
- phase 44's TP part on 2+ GPUs: the CLI's --model_devices 2 (and DP x
  TP with 4 GPUs) against one GPU and, fused (--fuse_fractions 8
  --device_cache true), against itself bit for bit; the CHiME step on 2
  distinct GPUs; with 4 GPUs the 1,024-cell BLSTM at 4 shards (44e);
- phase 49: fuse 8 against fuse 1 under a model mesh (5 shards of
  cuda:0; 2 GPUs), on SP and PP meshes across two processes over NCCL
  (2+ GPUs), and two processes on one card over gloo (the note).

With --distinct only the parts that need 2+ GPUs run (on a host of
four: `python3 scripts/torch_tp_fused.py --distinct`). Prints the cards'
names and power limits first. Exits 1 without a GPU. Imports torch, the
port and chip_smoke.py only.
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
        with torch.no_grad():
            cs.tp_kernels_vs_twins(torch)
        cs.tp_steps(torch, card)
    if n >= 2:
        gpus = [torch.device("cuda", j) for j in range(n)]
        cs.tp_steps(torch, card, mesh_of=lambda k: gpus[:k],
                    cases=(("autoencoding", cs.TP_CHIME),), bf16=False)
        if n >= cs.WIDE_TP_N:
            cs.tp_wide(torch, card)
    cs.fused_tp_span_phase(torch, card, distinct=distinct)
    if n >= 2:
        with tempfile.TemporaryDirectory(prefix="tp_fused_") as workdir:
            cs.pp_tp_cli(torch, workdir, n, kinds=("tp", "dp_tp"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
