#!/usr/bin/env python3
"""A/B of the port's LSTM recurrence kernels between two checkouts, on one
CUDA GPU.

    python3 scripts/torch_ab_recurrence.py PARENT_DIR CHANGE_DIR
    python3 scripts/torch_ab_recurrence.py DIR        # one checkout, once

Each directory holds a `lstm_rnn_tpu_torch/` package (for example the
parent commit unpacked with `git archive` into a directory .gitignore
lists). The checkouts run in turns, parent, change, change, parent, each
in its own process (each builds its own kernel library), and each prints:
the compiler's registers and spills of its recurrence kernels (forward
and BPTT) and the cluster size each recurrence launch takes (where the
checkout has a cluster plan, `lstm_cell.recurrence_plan`); then, f32 and
bf16, device milliseconds and microseconds a step, CUDA events, mean of
20 after a warm-up (the BPTT kernels alone by the profiler's device time,
mean of the launches it recorded in 5 calls, since their entry point also
launches the weight-gradient products):

- K0's and K1's recurrence (`_launch_rec`, save False / True) at one
  TIMIT BLSTM layer (T=800, B=50, P=250, H=125, D=2);
- K2 (`lstm_bwd`) whole, by events, and its `bptt_kernel` alone, at the
  training length (T=500, the same layer);
- the carry recurrence (K6f, `_launch_rec_carry`) over one 64-frame
  chunk of the streaming stack (B=64, H=250, D=1, from a non-zero state);
- the K6b pair at one sequence-parallel block of a TIMIT layer (T=125,
  B=50, H=125, D=1, dir_offset 0, from a non-zero state): the carry
  forward's recurrence with residuals (`_launch_rec_carry(save=True)`)
  and the carry BPTT's `bptt_carry_kernel` alone (and `lstm_bwd_carry`
  whole by events).

Prints the card's name and power limit first. Imports torch and the port
only.
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
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load()
    name = None
    for line in _build.build_log().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif name and ("rec" in name or "bptt" in name) and (
                "spill" in line or "registers" in line):
            short = re.sub(r".*?((rec|bptt)_\w*kernel)", r"\1", name)[:60]
            print(f"{label} {short}: {line.strip()[:90]}")
    plan = getattr(lc, "recurrence_plan", None)
    for H in (125, 250):
        for dt in (torch.float32, torch.bfloat16):
            for kind in ("fwd", "bwd"):
                if plan is None:
                    print(f"{label} H={H} {str(dt)[6:]} {kind}: one block "
                          "per 4 rows (no cluster plan)")
                    continue
                p = plan(H, dt, kind)
                print(f"{label} H={H} {str(dt)[6:]} {kind}: cluster of "
                      f"{p['n']}, {p['threads']} threads, "
                      f"{p['smem']:,} B shared, W_rec "
                      f"{'on chip' if p['w_on_chip'] else 'from L2'}")

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

    def device_ms(fn, part, reps=5):
        """Mean device ms of one launch of the kernel whose name holds
        `part`, by the launches the profiler recorded (the first ones of a
        window can go missing)."""
        fn()
        torch.cuda.synchronize()
        act = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=act) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if part in e.key]
        us = sum(getattr(e, "self_device_time_total", 0)
                 or getattr(e, "self_cuda_time_total", 0) for e in events)
        return us / 1e3 / max(1, sum(e.count for e in events))

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
    # one SP block of a TIMIT layer, one direction, from a non-zero state
    Tb = 125
    xb = x[:Tb].contiguous()
    w_inb, w_recb, peepb, biasb = (t[:1].contiguous() for t in
                                   (w_in, w_rec, peep, bias))
    lens_b = torch.full((B,), Tb, dtype=torch.int32, device="cuda")
    h0b = torch.rand(1, B, H, device="cuda") - 0.5
    c0b = torch.rand(1, B, H, device="cuda") - 0.5
    with torch.no_grad():
        for dt in (torch.float32, torch.bfloat16):
            tag = f"{label} {str(dt)[6:]}:"
            a = lc._launch_proj(x.to(dt), w_in.to(dt), bias, 1.0)
            wr = w_rec.to(dt)
            k0 = ms(lambda: lc._launch_rec(a, wr, peep, lengths))
            k1 = ms(lambda: lc._launch_rec(a, wr, peep, lengths, save=True))
            print(f"{tag} K0 recurrence {k0:.3f} ms = {1e3 * k0 / T:.2f} us "
                  f"a step, K1 recurrence {k1:.3f} ms = {1e3 * k1 / T:.2f} "
                  f"us a step [T={T} B={B} P={P} H={H} D={D}]", flush=True)
            # K2 at the training length
            tt = 500
            h, c, g = lc.lstm_fwd_save(x[:tt], w_in, w_rec, peep, bias,
                                       lengths.clamp(max=tt), 1.0, dt)
            dh = torch.randn(tt, B, D * H, device="cuda")

            def k2_call():
                return lc.lstm_bwd(x[:tt], w_in, w_rec, peep,
                                   lengths.clamp(max=tt), h, c, g, dh, 1.0,
                                   True, dt)
            k2 = ms(k2_call)
            k2r = device_ms(k2_call, "bptt_kernel")
            print(f"{tag} K2 {k2:.3f} ms whole, bptt_kernel {k2r:.3f} ms = "
                  f"{1e3 * k2r / tt:.2f} us a step [T={tt}]", flush=True)
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
            print(f"{tag} K6f recurrence {k6:.3f} ms = {1e3 * k6 / Tc:.2f} "
                  f"us a step [T={Tc} B={Bc} H={Hc} D=1]", flush=True)
            # the K6b pair at one SP block
            ab = lc._launch_proj(xb.to(dt), w_inb.to(dt), biasb, 1.0)
            wrb = w_recb.to(dt)
            k6bf = ms(lambda: lc._launch_rec_carry(ab, wrb, peepb, lens_b,
                                                   None, h0b, c0b, Tb, 0,
                                                   save=True))
            hb, cb, gb, _ = lc.lstm_fwd_save_carry(
                xb, w_inb, w_recb, peepb, biasb, lens_b, h0b, c0b, 1.0, dt)
            dhb = torch.randn(Tb, B, H, device="cuda")
            dhf = torch.rand(1, B, H, device="cuda") - 0.5
            dcf = torch.rand(1, B, H, device="cuda") - 0.5

            def k6bb_call():
                return lc.lstm_bwd_carry(xb, w_inb, w_recb, peepb, lens_b,
                                         hb, cb, gb, h0b, c0b, dhb, dhf, dcf,
                                         1.0, True, dt)
            k6bb = ms(k6bb_call)
            k6bbr = device_ms(k6bb_call, "bptt_carry_kernel")
            print(f"{tag} K6b-f recurrence {k6bf:.3f} ms = "
                  f"{1e3 * k6bf / Tb:.2f} us a step; K6b-b {k6bb:.3f} ms "
                  f"whole, bptt_carry_kernel {k6bbr:.3f} ms = "
                  f"{1e3 * k6bbr / Tb:.2f} us a step [T={Tb} B={B} H={H} "
                  "D=1]", flush=True)


def main():
    if sys.argv[1:2] == ["--worker"]:
        worker(*sys.argv[2:4])
        return 0
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"], check=True)
    if len(sys.argv) == 2:
        turns = ((sys.argv[1], "run"),)
    else:
        parent, change = sys.argv[1:3]
        turns = ((parent, "parent-1"), (change, "change-1"),
                 (change, "change-2"), (parent, "parent-2"))
    for root, label in turns:
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--worker", root, label], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
