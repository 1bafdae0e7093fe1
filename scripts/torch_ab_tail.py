#!/usr/bin/env python3
"""A/B of the port's tail kernels between two checkouts, on one CUDA GPU.

    python3 scripts/torch_ab_tail.py PARENT_DIR CHANGE_DIR

Each directory holds a `lstm_rnn_tpu_torch/` package (for example the
parent commit unpacked with `git archive` into a directory .gitignore
lists). The checkouts run in turns, parent, change, change, parent, each
in its own process (each builds its own kernel library), and each prints,
f32 and bf16, on operands already in the storage dtype:

- K3f (`softmax_ce_proj_fwd`, want_p on) at the TIMIT tail, N = 25,000,
  P = 250, S = 183, beside `F.cross_entropy(addmm(b, h, W), t, sum,
  ignore_index=-1)`;
- K3b (`softmax_ce_proj_bwd`) on K3f's p, beside cuBLAS's dh + dW on the
  same operands (`torch.matmul(dzc, W^T)` and `torch.matmul(h^T, dzc)`
  with dzc the twin's dz in the storage dtype: a yardstick, no one call
  computes K3b's function);
- K4f (`_launch_wide_fwd`) at the LVCSR tail, N = 25,000, S = 10,112,
  beside `F.cross_entropy(a, t, sum, ignore_index=-1)`;
- K4b (`_launch_wide_bwd`) at the LVCSR tail, P = 250, beside cuBLAS's
  dW on the same operands (`torch.matmul(h^T, dz)`, a yardstick: no one
  call computes K4b's function);
- K4's two products outside its kernels as each checkout routes them:
  the logits (`wide_logits`) and dh (`_wide_dh`);
- K5f (`softmax_ce_fwd`, want_p on) at N = 25,000, S = 183 and 10,112,
  on f32 logits (N(0, 9)), beside `F.cross_entropy(a, t, sum,
  ignore_index=-1)`, and K5b (`softmax_ce_bwd`) on K5f's p (no one call
  computes its function);

each as device time per call from the profiler (the kernels of the call;
the library call's kernels summed) and as CUDA events around 20 calls
(host work included), and the compiler's registers and spills of the
tail kernels. Prints the card's name and power limit first. Imports
torch and the port only.
"""

import os
import re
import subprocess
import sys


def device_ms(torch, fn, reps=20):
    """Device milliseconds of one call of fn: each kernel's mean device
    time times its launches per call, from one profile of `reps` calls
    after a warm-up (a profile may miss a window's first launches). {} of
    kernels when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.key_averages():
        us = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0) or 0)
        if str(getattr(e, "device_type", "")).endswith("CUDA") and us > 0:
            per[e.key] = us / 1e3 / e.count * max(1, round(e.count / reps))
    return sum(per.values()), per


def events_ms(torch, fn, reps=20):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def worker(root, label):
    import torch
    import torch.nn.functional as F
    sys.path.insert(0, os.path.abspath(root))
    from lstm_rnn_tpu_torch.ops import _build
    from lstm_rnn_tpu_torch.ops import softmax_ce as sc
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load()
    name = None
    for line in _build.build_log().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif name and re.search(r"(ce|wide|plain)_fwd_kernel|wide_(dz|bwd_"
                                r"\w+)_kernel|pb_\w+_kernel|ce_dz_kernel|"
                                r"plain_bwd_kernel", name) \
                and ("spill" in line or "registers" in line):
            short = re.sub(r".*?((ce|wide|pb|plain)_\w+_kernel)", r"\1",
                           name)[:60]
            print(f"{label} {short}: {line.strip()[:90]}")

    def show(what, fn, lib=None):
        dev, per = device_ms(torch, fn)
        text = (f"{label} {what}: device {dev:.4f} ms ("
                + ", ".join(f"{k[:40]} {v:.4f}" for k, v in per.items())
                + f"), events {events_ms(torch, fn):.4f} ms")
        if lib is not None:
            ldev, lper = device_ms(torch, lib)
            text += (f"; library device {ldev:.4f} ms ({len(lper)} kernels),"
                     f" events {events_ms(torch, lib):.4f} ms")
        print(text, flush=True)

    gen = torch.Generator("cuda").manual_seed(1234)
    N, P = 25_000, 250
    for S in (183, 10112):
        h2 = torch.randn(N, P, device="cuda", generator=gen) * 0.5
        W = (torch.rand(P, S, device="cuda", generator=gen) - 0.5) * 0.2
        b = (torch.rand(S, device="cuda", generator=gen) - 0.5) * 0.2
        tc = torch.randint(0, S, (N,), device="cuda", generator=gen,
                           dtype=torch.int32)
        tc[::10] = -1
        tl = tc.long()
        a5 = torch.randn(N, S, device="cuda", generator=gen) * 3
        with torch.no_grad():
            for dt in (torch.float32, torch.bfloat16):
                name = str(dt)[6:]
                show(f"K5f {name} [N={N} S={S}]",
                     lambda: sc.softmax_ce_fwd(a5, tc, dt),
                     lambda: F.cross_entropy(a5, tl, reduction="sum",
                                             ignore_index=-1))
                p5 = sc.softmax_ce_fwd(a5, tc, dt)[2]
                g5 = torch.tensor(1.0, device="cuda")
                show(f"K5b {name} [N={N} S={S}]",
                     lambda: sc.softmax_ce_bwd(p5, tc, g5))
                del p5
                if S == 183:
                    hs, Ws, bs = h2.to(dt), W.to(dt), b.to(dt)
                    show(f"K3f {name} [N={N} P={P} S={S}]",
                         lambda: sc.softmax_ce_proj_fwd(hs, Ws, b, tc, 1.0,
                                                        dt),
                         lambda: F.cross_entropy(
                             torch.addmm(bs, hs, Ws), tl, reduction="sum",
                             ignore_index=-1))
                    p = sc.softmax_ce_proj_fwd(hs, Ws, b, tc, 1.0, dt)[2]
                    g = torch.tensor(1.0, device="cuda")
                    dzc = sc.plain_dz_reference(p, tc, g).to(dt)
                    show(f"K3b {name} [N={N} P={P} S={S}]",
                         lambda: sc.softmax_ce_proj_bwd(p, hs, Ws, tc, g,
                                                        1.0, dt),
                         lambda: (torch.matmul(dzc, Ws.t()),
                                  torch.matmul(hs.t(), dzc)))
                    del p, dzc
                else:
                    a = sc.wide_logits(h2, W, b, 1.0, dt)
                    show(f"K4f {name} [N={N} S={S}]",
                         lambda: sc._launch_wide_fwd(a, tc),
                         lambda: F.cross_entropy(a, tl, reduction="sum",
                                                 ignore_index=-1))
                    _, _, off, ssum, pt = sc._launch_wide_fwd(a, tc)
                    hc, g = h2.to(dt), torch.tensor(1.0, device="cuda")
                    dz = sc._launch_wide_bwd(a, hc, tc, off, ssum, pt, g,
                                             1.0)[0]
                    show(f"K4b {name} [N={N} P={P} S={S}]",
                         lambda: sc._launch_wide_bwd(a, hc, tc, off, ssum,
                                                     pt, g, 1.0),
                         lambda: torch.matmul(hc.t(), dz))
                    show(f"logits product {name}",
                         lambda: sc.wide_logits(h2, W, b, 1.0, dt))
                    show(f"dh product {name}",
                         lambda: sc._wide_dh(dz, W, h2.dtype, dt))
                    del a, dz
        del h2, W, a5
        torch.cuda.empty_cache()


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
