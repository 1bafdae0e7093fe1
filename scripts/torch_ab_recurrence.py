#!/usr/bin/env python3
"""A/B of the port's LSTM recurrence kernels between two checkouts, on one
CUDA GPU.

    python3 scripts/torch_ab_recurrence.py PARENT_DIR CHANGE_DIR

Each directory holds a `lstm_rnn_tpu_torch/` package (for example the
parent commit unpacked with `git archive` into a directory .gitignore
lists). The checkouts run in turns, parent, change, change, parent, each
in its own process (each builds its own kernel library), and each prints:
the compiler's registers and spills of its recurrence kernels (forward
and BPTT), and, f32 and bf16, CUDA events, mean of 20 after a warm-up:
the device milliseconds of K0's and K1's recurrence (`_launch_rec`, save
False / True) at one TIMIT BLSTM layer (T=800, B=50, P=250, H=125, D=2);
of K2 (`lstm_bwd`, whole) at the training shape (T=500, the same layer);
and of the carry kernel's recurrence (K6f, `_launch_rec_carry`) over one
64-frame chunk of the streaming stack (B=64, H=250, D=1, from a non-zero
state). Prints the card's name and power limit first. Imports torch and
the port only.
"""

import os
import re
import subprocess
import sys


def worker(root, label):
    import numpy as np
    import torch
    sys.path.insert(0, os.path.abspath(root))
    from lstm_rnn_tpu_torch.ops import _build
    from lstm_rnn_tpu_torch.ops import lstm_cell as lc
    _build.load()
    name = None
    for line in _build.build_log().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif name and ("rec" in name or "bptt" in name) and (
                "spill" in line or "registers" in line):
            short = re.sub(r".*?((rec|bptt)_\w*kernel)", r"\1", name)[:50]
            print(f"{label} {short}: {line.strip()[:90]}")

    def ms(fn, reps=20):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    rng = np.random.RandomState(250)
    T, B, P, H, D = 800, 50, 250, 125, 2

    def u(*s):
        return torch.tensor(rng.uniform(-0.1, 0.1, s), dtype=torch.float32,
                            device="cuda")
    x = torch.tensor(rng.randn(T, B, P), dtype=torch.float32, device="cuda")
    w_in, w_rec, peep, bias = u(D, P, 4 * H), u(D, H, 4 * H), u(D, 3, H), \
        u(D, 4 * H)
    lengths = rng.randint(1, T + 1, B)
    lengths[0], lengths[-1] = T, 1
    lengths = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        for dt in (torch.float32, torch.bfloat16):
            a = lc._launch_proj(x.to(dt), w_in.to(dt), bias, 1.0)
            wr = w_rec.to(dt)
            k0 = ms(lambda: lc._launch_rec(a, wr, peep, lengths))
            k1 = ms(lambda: lc._launch_rec(a, wr, peep, lengths, save=True))
            print(f"{label} {str(dt)[6:]}: K0 recurrence {k0:.3f} ms, K1 "
                  f"recurrence {k1:.3f} ms [T={T} B={B} P={P} H={H} D={D}]",
                  flush=True)
            # K2 at the training length
            tt = 500
            h, c, g = lc.lstm_fwd_save(x[:tt], w_in, w_rec, peep, bias,
                                       lengths.clamp(max=tt), 1.0, dt)
            dh = torch.randn(tt, B, D * H, device="cuda")
            k2 = ms(lambda: lc.lstm_bwd(x[:tt], w_in, w_rec, peep,
                                        lengths.clamp(max=tt), h, c, g, dh,
                                        1.0, True, dt))
            # K6f over one streaming chunk
            Tc, Bc, Hc = 64, 64, 250
            ac = torch.randn(1, Tc, Bc, 4 * Hc, device="cuda")
            wc = (torch.rand(1, Hc, 4 * Hc, device="cuda") - 0.5) * 0.2
            pc = (torch.rand(1, 3, Hc, device="cuda") - 0.5) * 0.2
            lc_ = torch.full((Bc,), Tc, dtype=torch.int32, device="cuda")
            h0 = torch.rand(1, Bc, Hc, device="cuda") - 0.5
            c0 = torch.rand(1, Bc, Hc, device="cuda") - 0.5
            wcd = wc.to(dt)
            k6 = ms(lambda: lc._launch_rec_carry(ac, wcd, pc, lc_, None, h0,
                                                 c0, Tc, 0))
            print(f"{label} {str(dt)[6:]}: K2 {k2:.3f} ms [T={tt}]; K6f "
                  f"recurrence {k6:.3f} ms [T={Tc} B={Bc} H={Hc} D=1]",
                  flush=True)


def main():
    if sys.argv[1:2] == ["--worker"]:
        worker(*sys.argv[2:4])
        return 0
    parent, change = sys.argv[1:3]
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"], check=True)
    for root, label in ((parent, "parent-1"), (change, "change-1"),
                        (change, "change-2"), (parent, "parent-2")):
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--worker", root, label], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
