#!/usr/bin/env python3
"""A/B of chip_smoke.py's training rates between two checkouts, on one
CUDA GPU.

    python3 scripts/torch_ab_rates.py PARENT_DIR CHANGE_DIR [PHASES]

Each directory holds `chip_smoke.py` and its `lstm_rnn_tpu_torch/`
package (for example the parent commit unpacked with `git archive` into a
directory .gitignore lists). The checkouts run in turns, parent, change,
change, parent, each in its own process (each builds its own kernel
library), and each runs its own chip_smoke.py's rate phases: serving
over a TIMIT-shaped corpus (phase 5), the TIMIT and LVCSR training steps
(phases 8 and 12), streaming in 64-frame chunks (phase 17), the
sequence-parallel step on four blocks of one card beside the
single-device step (phase 20), and the --remat_blocks steps with their
peak memory (phase 25), f32 and bf16; PHASES (for example 8,12) runs only
those of the six. Each line is prefixed by the run's label. Prints the
card's name and power limit first. Imports torch and the port only.
"""

import contextlib
import io
import os
import subprocess
import sys
import tempfile


def worker(root, label, phases):
    import torch
    sys.path.insert(0, os.path.abspath(root))
    import chip_smoke as cs
    from lstm_rnn_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load()
    card = cs.card_line()
    out = io.StringIO()

    def serving():
        with tempfile.TemporaryDirectory(prefix="ab_rates_") as workdir:
            cs.forward_rates(torch, cs.write_inputs(workdir)[0], card)

    def streaming():
        with torch.inference_mode():
            cs.stream_rates(torch, card)
    runs = {"5": serving, "17": streaming,
            "8": lambda: cs.train_rates(torch, card),
            "12": lambda: cs.lvcsr_rates(torch, card),
            "20": lambda: cs.sp_rates(torch, card, [cs.sp_mesh(torch)]),
            "25": lambda: cs.remat_rates_memory(torch, card)}
    with contextlib.redirect_stdout(out):
        for phase in phases.split(","):
            runs[phase]()
    for line in out.getvalue().splitlines():
        if "frames/s" in line:
            print(f"{label} {line}", flush=True)


def main():
    if sys.argv[1:2] == ["--worker"]:
        worker(*sys.argv[2:5])
        return 0
    parent, change = sys.argv[1:3]
    phases = sys.argv[3] if len(sys.argv) > 3 else "5,8,12,17,20,25"
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"], check=True)
    for root, label in ((parent, "parent-1"), (change, "change-1"),
                        (change, "change-2"), (parent, "parent-2")):
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--worker", root, label, phases], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
