#!/usr/bin/env python3
"""The CHiME recipes, weight noise and --init_rng currennt on one GPU.

    python3 scripts/torch_chime_phases.py

Runs chip_smoke.py's phases 30-32 alone (after the kernels' build), each
to its end even when an earlier one fails:

- 30a: each CHiME width's cluster plan, and K0, K1, K2 at every CHiME
  layer and K3f/K3b at the recognition tail against their twins, timed;
- 30b: cli.main with each CHiME recipe's config.cfg, f32 and bf16, 2
  epochs, and the --input_noise_sigma 0 control;
- 32: cli.main --init_rng currennt on the TIMIT network;
- 31a-c: the first weight-noise draw against numpy's stream, and one
  noisy step through the kernel route, the scan route, SP and remat;
- 31d: the step's frames/s with and without weight noise, the host draw
  alone, and a profile of one noisy step (TIMIT and CHiME
  no_subsampling).

Prints the card's name and power limit first. Exits 1 when a phase
failed or torch sees no GPU. Imports torch, the port and chip_smoke.py
only.
"""

import os
import sys
import tempfile
import time
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def main():
    import torch
    if not torch.cuda.is_available():
        print("torch sees no CUDA GPU", file=sys.stderr)
        return 1
    from lstm_rnn_tpu_torch.ops import _build
    card = cs.card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.load()
    cs.phase("build", f"kernel library ready in "
             f"{time.perf_counter() - t0:.1f} s")
    failed = []

    def run(name, fn):
        t = time.perf_counter()
        try:
            fn()
        except Exception:  # noqa: BLE001 (reported, the next phase runs)
            traceback.print_exc()
            failed.append(name)
        cs.phase(name, f"{time.perf_counter() - t:.1f} s")

    def kernels():
        with torch.no_grad():
            cs.chime_plans(torch)
            cs.chime_kernels_vs_twins(torch)
    with tempfile.TemporaryDirectory(prefix="chime_phases_") as workdir:
        run("30a", kernels)
        run("30b", lambda: cs.chime_cli(torch, workdir))
        run("32", lambda: cs.init_rng_cli(torch, workdir))
    run("31a", lambda: cs.noise_draw_on_card(torch))
    run("31b-c", lambda: cs.noisy_steps(torch))
    run("31d", lambda: cs.noisy_rates(torch, card))
    print("failed: " + ", ".join(failed) if failed else "all phases passed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
